"""The recurrent and cross-attention families over a 'model' axis on the
CPU: Mamba2 and mLSTM on each column's heads, sLSTM on every head,
cross-attention and ``vision_proj`` tensor-parallel. gloo ranks on (1, 2),
(2, 2) and, to compare with, (2, 1) meshes (``tests/torch_tp_ssm_ranks.
py`` holds what each rank runs), against the reference's forward,
gradient and exact_tp step on the same numpy weights (one device, one
client) and against the port's own run on one column.

Cases, all f32 (compute and parameters), at the reduced configs:
  * ``zamba``: zamba2-2.7b, 2 groups of one Mamba2 layer (8 heads, 4 a
    column; ``in_proj`` 1,064 wide, cut across its [z | x | B | C | dt]
    segments; 64 tokens, two chunks) and the shared block. ``d_ff`` is
    set to 257, which zamba2 reads nowhere: the shared block's MLP is
    ``shared_block_d_ff`` wide (256), and a block split by ``d_ff`` would
    not run;
  * ``xlstm``: xlstm-350m, 7 mLSTM blocks (4 heads, 2 a column) and 1
    sLSTM block, on 64 tokens (the chunked mLSTM form);
  * ``whisper``: whisper-medium, its encoder and decoder blocks (4 heads,
    2 a column) over 16 frames;
  * ``vlm``: llama-3.2-vision-11b at depth 4 (two groups of a self layer
    and a gated cross layer, both tanh gates set away from 0), over 16
    patches through a column-split ``vision_proj``;
  * ``xlstm3``: that xLSTM with 3 heads at d_model 192: the heads do not
    divide M = 2 while every leaf but sLSTM's ``r`` does, so every column
    runs every head.

Tolerances: logits, losses, gradients and new parameters within rtol 1e-4
of the reference's or the one-column run's, each leaf with an absolute
floor of 1e-4 of its largest magnitude (the model axis's sums add in
another order). Greedy tokens are equal, and each rank's cache holds its
part of the one-column run's numbers. Whole leaves' gradients and new
values are the same bits on every column of a row.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_get, tree_paths
from repro_torch.launch import sharding
from repro_torch.models import attention, ssm, transformer
from test_torch_cross_models import _gates
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401
from test_torch_ssm import draw_like
from test_torch_tp import _Axis, _mesh, _row_ranks, _trees_close
import torch_tp_ranks as ranks
import torch_tp_ssm_ranks

RTOL = 1e-4
# (name, ranks, model columns, whether the ranks run the FL harness, first
# process): (1, 2) and (2, 1) at once on processes 0-1 and 2-3, then (2, 2)
GROUPS = (("m12", 2, 2, False, 0), ("m21", 2, 1, False, 2),
          ("m22", 4, 2, False, 0))
CASES = ("zamba", "xlstm", "whisper", "vlm", "xlstm3")
STEPS = ("exact_tp", "exact_tp_sketch", "fedavg")
SEQ = {"zamba": 64, "xlstm": 64, "xlstm3": 32}          # else 16


def _configs(reference):
    """(name, reference config, port config) of each case, f32."""
    out = []
    for name, arch, kw in (
            ("zamba", "zamba2-2.7b", dict(d_ff=257)),
            ("xlstm", "xlstm-350m", {}),
            ("whisper", "whisper-medium", {}),
            ("vlm", "llama-3.2-vision-11b", dict(n_layers=4)),
            ("xlstm3", "xlstm-350m", dict(n_heads=3, d_model=192))):
        out.append((name, *(dataclasses.replace(
            c.reduced(), dtype="float32", param_dtype="float32", **kw)
            for c in (reference.configs.get_config(arch),
                      get_config(arch)))))
    return out


def _case(reference, name, jc, tc, seed):
    w = _gates(draw_like(lambda: reference.transformer.init_model(
        jax.random.PRNGKey(0), jc), seed), seed)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, tc.vocab_size, size=(4, SEQ.get(name, 16) + 1))
    batch = {"tokens": tok[:, :-1].astype(np.int32),
             "labels": tok[:, 1:].astype(np.int32)}
    if tc.encoder is not None:
        batch["frames"] = 0.5 * rng.standard_normal(
            (4, tc.encoder.n_frames, tc.d_model)).astype(np.float32)
    if tc.vision is not None:
        batch["patches"] = 0.5 * rng.standard_normal(
            (4, tc.vision.n_patches, tc.vision.d_vision)).astype(np.float32)
    return {"name": name, "cfg": tc, "weights": w, "seed": seed,
            "batch": batch, "init_shards": name in ("zamba", "vlm")}


def _reference_runs(reference, cases, jcs, pool):
    """The reference's logits, loss, gradient and exact_tp step of each
    case, one client on a one-device mesh (its lambda is 1, so the step is
    also the fedavg step); its greedy prefill token is the last position's
    argmax. Returns the futures of ``pool``'s runs, by case."""
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    R, T = reference.pod, reference.transformer

    def one(case):
        jc = jcs[case["name"]]
        b = {k: jnp.asarray(x) for k, x in case["batch"].items()}
        step = R.make_tp_train_step(
            jc, reference.base.FLConfig(num_clients=1, **ranks.FL), mesh)

        def run(p, bb):
            logits = T.forward(p, {k: v for k, v in bb.items()
                                   if k != "labels"}, jc)[0]
            loss, grads = jax.value_and_grad(
                lambda q: R.loss_fn(q, bb, jc)[0])(p)
            return logits, loss, grads, step(p, bb)
        logits, loss, grads, (new, metrics) = jax.jit(run)(
            case["weights"], b)
        logits = np.asarray(logits)
        stepped = {"params": to_numpy_tree(new),
                   "metrics": {k: float(v) for k, v in metrics.items()}}
        return {"logits": logits, "loss": float(loss),
                "grads": to_numpy_tree(grads), "exact_tp": stepped,
                "fedavg": {"params": stepped["params"],
                           "metrics": {"loss": stepped["metrics"]["loss"]}},
                "prefill": np.argmax(logits[:, -1], axis=-1)}
    return {c["name"]: pool.submit(one, c) for c in cases}


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    configs = _configs(reference)
    cases = [_case(reference, name, jc, tc, seed)
             for seed, (name, jc, tc) in enumerate(configs)]
    jcs = {name: jc for name, jc, _ in configs}
    payload = {"cases": cases}

    def meanwhile():
        # two reference cases compile at once while the one-column run and
        # the ranks run
        with ThreadPoolExecutor(2) as pool:
            ref = _reference_runs(reference, cases, jcs, pool)
            before = torch.get_num_threads()
            try:
                one = torch_tp_ssm_ranks.run_cases(payload, 1)
            finally:
                torch.set_num_threads(before)
            return one, {k: f.result() for k, f in ref.items()}
    groups, (one, ref) = ranks.spawn(GROUPS, payload,
                                     tmp_path_factory.mktemp("tp_ssm"),
                                     meanwhile=meanwhile,
                                     job=torch_tp_ssm_ranks.run_cases)
    return {"cases": {c["name"]: c for c in cases}, "groups": groups,
            "one": one, "ref": ref}


def _logits(rows: list, cfg, name: str) -> np.ndarray:
    parts = [r[name]["logits"] for r in rows]
    if transformer.vocab_split(cfg, _Axis(len(rows))):
        return np.concatenate(parts, axis=-1)
    return parts[0]


@functools.lru_cache(maxsize=None)
def _spec_tree(cfg, shape: tuple):
    return sharding.param_shardings(transformer.init_model(None, cfg),
                                    _mesh(dict(shape)))


def _specs(cfg, shape: dict):
    return _spec_tree(cfg, tuple(shape.items()))


def _unshard(rows: list, key, cfg, pick=lambda r: r):
    """The whole tree from one row's ranks' shards of ``pick(r)[key]`` (in
    column order): each split leaf's parts concatenated along its split
    dimension."""
    specs = _specs(cfg, rows[0]["shape"])
    trees = [pick(r)[key] for r in rows]
    out = {}
    for path in tree_paths(trees[0]):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        parts = [np.asarray(tree_get(t, path)) for t in trees]
        dims = [i for i, e in enumerate(tree_get(specs, path).spec)
                if e == "model"]
        node[path[-1]] = (np.concatenate(parts, axis=dims[0]) if dims
                          else parts[0])
    return out


def test_the_cases_split_as_they_say(runs):
    """The packed leaves split by column across their segments, ``A_log``
    and sLSTM's ``r`` on heads (``r`` whole where 3 heads do not divide),
    ``vision_proj`` by column, the norms, ``gate_bias`` and the tanh gates
    whole; and the scores' layout counts every split leaf, stacked ones
    and ``r`` among them, as split."""
    shape = {"data": 1, "model": 2}
    spec = {name: _specs(runs["cases"][name]["cfg"], shape)
            for name in CASES}

    def at(name, *path):
        return tree_get(spec[name], path).spec
    for leaf in ("in_proj", "conv_w"):
        assert at("zamba", "mamba_layers", "m", leaf) == (
            None, None, None, "model")
    assert at("zamba", "mamba_layers", "m", "A_log") == (None, None, "model")
    assert at("zamba", "mamba_layers", "m", "out_proj") == (
        None, None, "model", None)
    for name in ("xlstm", "xlstm3"):
        for leaf in ("up_proj", "w_gates", "wq"):
            assert at(name, "mlstm_layers", "m", leaf) == (
                None, None, None, "model")
        assert at(name, "mlstm_layers", "m", "gate_bias") == ()
        assert at(name, "slstm_layers", "s", "w_in") == (None, None, "model")
    assert at("xlstm", "slstm_layers", "s", "r") == (
        None, "model", None, None)
    assert at("xlstm3", "slstm_layers", "s", "r") == (None, None, None, None)
    assert at("vlm", "vision_proj") == (None, "model")
    assert at("vlm", "cross_layers", "xattn", "wk") == (None, None, "model")
    assert at("vlm", "cross_layers", "gate_attn") == ()
    assert at("whisper", "dec_layers", "xattn", "wo") == (None, "model", None)
    for name, path, split in (
            ("zamba", ("mamba_layers", "m", "in_proj"), True),
            ("zamba", ("mamba_layers", "m", "norm", "scale"), False),
            ("xlstm", ("slstm_layers", "s", "r"), True),
            ("xlstm3", ("slstm_layers", "s", "r"), False)):
        meta = transformer.init_model(None, runs["cases"][name]["cfg"])
        layout = sharding.ModelLayout(
            _mesh(shape), {p: tree_get(spec[name], p).spec
                           for p in tree_paths(meta)},
            {p: tuple(tree_get(meta, p).shape) for p in tree_paths(meta)},
            None)
        assert layout.split(path) == split, (name, path)
    assert ssm.mamba_local(runs["cases"]["zamba"]["cfg"], 2)
    assert ssm.heads_local(4, 2) and not ssm.heads_local(3, 2)
    assert attention.tp_split(runs["cases"]["vlm"]["cfg"], 2)[2]


@pytest.mark.parametrize("case", CASES)
def test_forward_and_loss_match_the_reference(runs, case):
    cfg = runs["cases"][case]["cfg"]
    rows = runs["groups"]["m12"]
    ref = runs["ref"][case]
    np.testing.assert_allclose(_logits(rows, cfg, case), ref["logits"],
                               rtol=RTOL, atol=RTOL * np.abs(
                                   ref["logits"]).max())
    for r in rows:
        np.testing.assert_allclose(r[case]["loss"], ref["loss"], rtol=RTOL)


# the leaves each case's gradient test names (the packed, the head-split
# and the column-split ones this file is about)
NAMED = {"zamba": {"in_proj", "conv_w", "A_log"},
         "xlstm": {"up_proj", "w_gates", "r", "w_in"},
         "xlstm3": {"up_proj", "w_gates", "r", "w_in"},
         "whisper": {"wq", "wk", "wv", "wo"},
         "vlm": {"vision_proj", "gate_attn", "gate_mlp"}}


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_the_reference_and_the_one_column_run(runs, case):
    """Every leaf's gradient on (1, 2), put together from the columns'
    shards, against the reference's and the one-column run's."""
    cfg = runs["cases"][case]["cfg"]
    got = _unshard(runs["groups"]["m12"], "grads", cfg, lambda r: r[case])
    _trees_close(got, runs["one"][case]["grads"])
    _trees_close(got, runs["ref"][case]["grads"])
    assert NAMED[case] <= {p[-1] for p in tree_paths(got)}


@pytest.mark.parametrize("group", ("m12", "m22"))
@pytest.mark.parametrize("case", CASES)
def test_whole_leaves_are_the_same_bits_on_every_column(runs, case, group):
    cfg = runs["cases"][case]["cfg"]
    rows = runs["groups"][group]
    specs = _specs(cfg, rows[0]["shape"])
    whole = [p for p in tree_paths(specs)
             if "model" not in tree_get(specs, p).spec]
    assert any(p[-1] == "scale" for p in whole)
    for row in range(rows[0]["shape"]["data"]):
        mine = _row_ranks(rows, row)
        for path in whole:
            for get in ([lambda r: r[case]["grads"]]
                        + [lambda r, s=s: r[case][s]["params"]
                           for s in STEPS]):
                want = tree_get(get(mine[0]), path)
                for r in mine[1:]:
                    np.testing.assert_array_equal(tree_get(get(r), path),
                                                  want, err_msg=str(path))


@pytest.mark.parametrize("step", ("exact_tp", "fedavg"))
@pytest.mark.parametrize("case", CASES)
def test_steps_on_one_row_match_the_reference(runs, case, step):
    cfg = runs["cases"][case]["cfg"]
    ref = runs["ref"][case][step]
    rows = runs["groups"]["m12"]
    _trees_close(_unshard(rows, "params", cfg, lambda r: r[case][step]),
                 ref["params"])
    for r in rows:
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(r[case][step]["metrics"][k], v,
                                       rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_sketched_exact_tp_is_the_one_column_run(runs, case):
    cfg = runs["cases"][case]["cfg"]
    one = runs["one"][case]["exact_tp_sketch"]
    rows = runs["groups"]["m12"]
    _trees_close(_unshard(rows, "params", cfg,
                          lambda r: r[case]["exact_tp_sketch"]),
                 one["params"])
    for r in rows:
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(
                r[case]["exact_tp_sketch"]["metrics"][k], v, rtol=RTOL,
                err_msg=k)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("case", CASES)
def test_two_rows_of_two_columns_match_two_rows_of_one(runs, case, step):
    cfg = runs["cases"][case]["cfg"]
    tp, rows = runs["groups"]["m22"], runs["groups"]["m21"]
    for row in range(2):
        mine = _row_ranks(tp, row)
        want = rows[row][case][step]
        _trees_close(_unshard(mine, "params", cfg, lambda r: r[case][step]),
                     want["params"])
        for r in mine:
            for k, v in want["metrics"].items():
                np.testing.assert_allclose(r[case][step]["metrics"][k], v,
                                           rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(_logits(mine, cfg, case),
                                   rows[row][case]["logits"], rtol=RTOL,
                                   atol=RTOL * np.abs(
                                       rows[row][case]["logits"]).max())


def _column_part(path, whole, cfg, col: int, M: int = 2):
    """Column ``col``'s part of the one-column cache leaf at ``path``: the
    local heads of Mamba2's state and of the attention caches, the window
    of Mamba2's x channels beside the whole B and C, mLSTM's local heads
    of C, n and m; mLSTM's window and sLSTM's states whole."""
    def cut(a, axis, n):
        w = a.shape[axis] // n
        return np.take(a, np.arange(col * w, (col + 1) * w), axis=axis)
    kind, leaf = path[0], path[-1]
    if kind == "mamba" and leaf == "h":
        return cut(whole, -3, M)
    if kind == "mamba" and leaf == "conv":
        d_inner = ssm.mamba_dims(cfg)[0]
        return np.concatenate([cut(whole[..., :d_inner], -1, M),
                               whole[..., d_inner:]], axis=-1)
    if kind == "mlstm" and leaf in ("C", "n", "m"):
        if not ssm.heads_local(cfg.n_heads, M):
            return whole
        return cut(whole, -1 if leaf == "m" else (-2 if leaf == "n" else -3),
                   M)
    if leaf in ("k", "v") and attention.tp_split(cfg, M)[2]:
        return cut(whole, -2, M)
    return whole


@pytest.mark.parametrize("case", CASES)
def test_prefill_decode_and_the_caches(runs, case):
    """Greedy prefill tokens: (1, 2)'s and the one-column run's are the
    reference's, and each (2, 2) row's those of its (2, 1) row. Decode:
    every rank's tokens are the one-column run's, and its cache (Mamba2's
    h and conv window, mLSTM's C/n/m, sLSTM's c/n/m/h, the KV caches)
    holds its column's part of the one-column run's numbers."""
    ref = runs["ref"][case]["prefill"]
    one = runs["one"][case]
    np.testing.assert_array_equal(one["prefill"], ref)
    for r in runs["groups"]["m12"]:
        np.testing.assert_array_equal(r[case]["prefill"], ref)
    for r in runs["groups"]["m22"]:
        np.testing.assert_array_equal(
            r[case]["prefill"], runs["groups"]["m21"][r["row"]][case][
                "prefill"])
    cfg = runs["cases"][case]["cfg"]
    kinds = {p[0] for p in tree_paths(one["cache"])}
    assert kinds == {"zamba": {"mamba", "attn"}, "whisper": {"self"},
                     "vlm": {"self"}}.get(case, {"mlstm", "slstm"})
    for group in ("m12", "m22", "m21"):
        for r in runs["groups"][group]:
            M = r["shape"]["model"]
            lo = 2 * r["row"] if group != "m12" else 0
            hi = lo + (2 if group != "m12" else 4)
            np.testing.assert_array_equal(r[case]["decode"],
                                          one["decode"][lo:hi])
            for path in tree_paths(one["cache"]):
                want = tree_get(one["cache"], path)
                # the batch axis follows the stack axes
                lead = 2 if path[0] in ("mamba", "mlstm") or (
                    path[0] == "self" and cfg.vision is not None) else 1
                want = np.take(want, np.arange(lo, hi), axis=lead)
                if M > 1:
                    want = _column_part(path, want, cfg, r["col"], M)
                np.testing.assert_allclose(
                    tree_get(r[case]["cache"], path), want, rtol=RTOL,
                    atol=RTOL * max(np.abs(want).max(), 1e-30),
                    err_msg=str(path))


def test_init_shards_draws_the_whole_trees_shards(runs):
    """``sharding.init_shards`` (a leaf drawn whole, cut, freed) gives each
    rank the bits ``shard_params`` cuts from ``init_model``'s whole tree,
    Mamba2's constant-filled leaves and the zero gates among them."""
    for group in ("m12", "m22"):
        for r in runs["groups"][group]:
            for case in ("zamba", "vlm"):
                assert r[case]["init_shards_equal"], (group, case)
