"""Tensor parallelism over a 'model' axis (the dense GQA decoders) on the
CPU: gloo ranks on (1, 2), (2, 2) and, to compare with, (2, 1) meshes
(``tests/torch_tp_ranks.py`` holds what each rank runs), against the
reference's forward and steps on the same numpy weights (a one-device
``jax.make_mesh((1, 1), ("data", "model"))``) and against the port's own
run on one column.

Cases: a reduced qwen1.5-4b (4 heads over 4 kv heads, qkv bias, set
non-zero here), a reduced deepseek-coder-33b (4 over 2, GQA 2:1), both
split on whole heads at M = 2 (each column its own heads, flash on them,
a cache of the local kv heads); and that deepseek-coder with one kv head
and a vocabulary of 511, where M = 2 splits ``wk``/``wv`` inside the head
(the columns are gathered and every column runs every head) and leaves
``lm_head`` whole (511 does not divide; the logits stay whole and the
plain cross-entropy runs), the divisibility drop of
``launch/sharding.param_spec``; and qwen1.5-4b with tied embeddings (no
zoo config ties them): the d-split table's partial logits are
model-summed into the whole vocabulary's on every column.

Tolerances: logits, losses, gradients and new parameters within rtol 1e-4
of the reference's or the one-column run's, each leaf with an absolute
floor of 1e-4 of its largest magnitude (f32 sums split over the columns
add in another order); ``bk`` takes ``bq``'s floor, its gradient being
cancellation remainders (``tests/test_torch_pod.py``). Greedy tokens are
equal. Whole leaves' gradients and new values are the same bits on every
column of a row, and the FL harness on (1, 2) equals the one-column run
bit for bit (its paper models are whole).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_get, tree_paths
from repro_torch.launch import sharding
from repro_torch.launch.mesh import HostMesh
from repro_torch.models import transformer
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401
import torch_tp_ranks as ranks

RTOL = 1e-4
# (name, ranks, model columns, whether the ranks run the FL harness)
GROUPS = (("m12", 2, 2, True), ("m22", 4, 2, False), ("m21", 2, 1, False))
HARNESS = (("osafl exact_tp", "osafl", "exact_tp",
            dict(model="mlp", dataset=2, num_clients=8, rounds=3,
                 capacity=(12, 24), arrivals=4, batch=8, seed=5)),)
CASES = ("qwen", "deepseek", "split_head", "tied")
STEPS = ("exact_tp", "exact_tp_sketch", "fedavg")


def _configs(reference):
    """(name, reference config, port config) of each case, f32 compute."""
    out = []
    for name, arch, kw in (
            ("qwen", "qwen1.5-4b", {}),
            ("deepseek", "deepseek-coder-33b", {}),
            ("split_head", "deepseek-coder-33b",
             dict(n_kv_heads=1, vocab_size=511)),
            ("tied", "qwen1.5-4b", dict(tie_embeddings=True))):
        jc = dataclasses.replace(reference.configs.get_config(arch).reduced(),
                                 dtype="float32", **kw)
        tc = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                 **kw)
        out.append((name, jc, tc))
    return out


def _case(reference, name, jc, tc, seed):
    w = to_numpy_tree(reference.transformer.init_model(
        jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    for path in tree_paths(w):
        if path[-1] in ("bq", "bk", "bv"):
            node = tree_get(w, path[:-1])
            node[path[-1]] = 0.02 * rng.standard_normal(
                node[path[-1]].shape).astype(np.float32)
    tok = rng.integers(0, tc.vocab_size, size=(4, 17))
    return {"name": name, "cfg": tc, "weights": w,
            "batch": {"tokens": tok[:, :-1].astype(np.int32),
                      "labels": tok[:, 1:].astype(np.int32)}}


def _reference_runs(reference, cases, jcs):
    """The reference's logits, loss and exact_tp step of each case, one
    client on a one-device mesh. With one client lambda is 1, so its
    exact_tp step is also the fedavg step the port's is held to; its
    greedy prefill token is the last position's argmax (its
    ``make_prefill_step``)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    R = reference.pod
    out = {}
    for case in cases:
        jc = jcs[case["name"]]
        w = case["weights"]
        b = {k: jnp.asarray(x) for k, x in case["batch"].items()}
        jfl = reference.base.FLConfig(num_clients=1, **ranks.FL)

        def logits_and_loss(p, bb, jc=jc):
            return (reference.transformer.forward(p, bb, jc)[0],
                    R.loss_fn(p, bb, jc)[0])
        logits, loss = jax.jit(logits_and_loss)(w, b)
        logits = np.asarray(logits)
        new, metrics = jax.jit(R.make_tp_train_step(jc, jfl, mesh))(w, b)
        step = {"params": to_numpy_tree(new),
                "metrics": {k: float(v) for k, v in metrics.items()}}
        out[case["name"]] = {
            "logits": logits, "loss": float(loss), "exact_tp": step,
            "fedavg": {"params": step["params"],
                       "metrics": {"loss": step["metrics"]["loss"]}},
            "prefill": np.argmax(logits[:, -1], axis=-1)}
    return out


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    configs = _configs(reference)
    cases = [_case(reference, name, jc, tc, seed)
             for seed, (name, jc, tc) in enumerate(configs)]
    jcs = {name: jc for name, jc, _ in configs}
    payload = {"cases": cases, "harness": HARNESS}

    def meanwhile():
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = ranks.run_cases(payload, 1)
        finally:
            torch.set_num_threads(before)
        return one, _reference_runs(reference, cases, jcs)
    groups, (one, ref) = ranks.spawn(GROUPS, payload,
                                     tmp_path_factory.mktemp("tp"),
                                     meanwhile=meanwhile)
    return {"cases": {c["name"]: c for c in cases}, "groups": groups,
            "one": one, "ref": ref}


def _mesh(shape: dict) -> HostMesh:
    return HostMesh(np.full(tuple(shape.values()), None, dtype=object),
                    tuple(shape))


def _unshard(rows: list, key, cfg, pick=lambda r: r):
    """The whole tree from each rank's shards of ``pick(row[case])[key]``
    (one row's ranks: ``rows`` in rank order)."""
    mesh = _mesh(rows[0]["shape"])
    trees = [pick(r)[key] for r in rows]
    specs = sharding.param_shardings(transformer.init_model(None, cfg), mesh)
    out = {}
    for path in tree_paths(trees[0]):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        shards = [torch.from_numpy(np.asarray(tree_get(t, path)))
                  for t in trees]
        whole = sharding.unshard(shards, tree_get(specs, path).spec, mesh)
        node[path[-1]] = whole.numpy()
    return out


def _row_ranks(group: list, row: int) -> list:
    """One client row's ranks, in column order, out of a group's rows."""
    return [r for r in group if r["row"] == row]


def _trees_close(got, want, rtol=RTOL):
    assert tree_paths(got) == tree_paths(want)
    for path in tree_paths(want):
        w = np.asarray(tree_get(want, path))
        floor = (tree_get(want, path[:-1] + ("bq",)) if path[-1] == "bk"
                 else w)
        np.testing.assert_allclose(tree_get(got, path), w, rtol=rtol,
                                   atol=rtol * np.abs(floor).max(),
                                   err_msg=str(path))


def _logits(rows: list, cfg, name: str) -> np.ndarray:
    parts = [r[name]["logits"] for r in rows]
    if transformer.vocab_split(cfg, _Axis(len(rows))):
        return np.concatenate(parts, axis=-1)
    return parts[0]


@dataclasses.dataclass
class _Axis:
    size: int


def test_ranks_lie_row_major_over_data_and_model(runs):
    """Rank = row * M + column, and ``model_sum``/``model_cat`` run over
    the M ranks of a row (the identity on one column)."""
    for name, n, M, _ in GROUPS:
        got = [(r["rank"], r["row"], r["col"]) for r in runs["groups"][name]]
        assert got == [(k, k // M, k % M) for k in range(n)]
        assert all(r["shape"] == {"data": n // M, "model": M}
                   for r in runs["groups"][name])
        # the model-axis collectives run along each row, in rank order
        for r in runs["groups"][name]:
            row = [r["row"] * M + c for c in range(M)]
            assert r["model_cat"] == [float(k) for k in row]
            assert r["model_sum"] == float(sum(row))


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


@pytest.mark.parametrize("case", CASES)
def test_gradients_gather_to_the_one_column_run(runs, case):
    cfg = runs["cases"][case]["cfg"]
    got = _unshard(runs["groups"]["m12"], "grads", cfg,
                   lambda r: r[case])
    _trees_close(got, runs["one"][case]["grads"])


@pytest.mark.parametrize("group", ("m12", "m22"))
@pytest.mark.parametrize("case", CASES)
def test_whole_leaves_are_the_same_bits_on_every_column(runs, case, group):
    """Norms (and any leaf the rules leave whole): gradients and the new
    values of each step are bit-equal on every column of a row."""
    cfg = runs["cases"][case]["cfg"]
    rows = runs["groups"][group]
    mesh = _mesh(rows[0]["shape"])
    specs = sharding.param_shardings(transformer.init_model(None, cfg), mesh)
    whole = [p for p in tree_paths(specs)
             if "model" not in tree_get(specs, p).spec]
    assert any(p[-1] == "scale" for p in whole)
    for row in range(mesh.shape["data"]):
        mine = _row_ranks(rows, row)
        for path in whole:
            for get in ([lambda r: r[case]["grads"]]
                        + [lambda r, s=s: r[case][s]["params"]
                           for s in STEPS]):
                ref = tree_get(get(mine[0]), path)
                for r in mine[1:]:
                    np.testing.assert_array_equal(tree_get(get(r), path),
                                                  ref, err_msg=str(path))


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
def test_sketched_exact_tp_acts_on_the_logical_tree(runs, case):
    """The count sketch over a split leaf takes the signs and buckets of
    the whole leaf's indices: the sketched step on (1, 2) is the
    one-column run's."""
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
    """(2, 2) against the port's (2, 1) run: the rows' sums run down each
    column, the model's over each row."""
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


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_give_the_same_greedy_tokens(runs, case):
    ref = runs["ref"][case]["prefill"]
    one = runs["one"][case]
    np.testing.assert_array_equal(one["prefill"], ref)
    for group in ("m12", "m22", "m21"):
        for r in runs["groups"][group]:
            lo = 2 * r["row"] if group != "m12" else 0
            hi = lo + (2 if group != "m12" else 4)
            np.testing.assert_array_equal(r[case]["prefill"], ref[lo:hi])
            np.testing.assert_array_equal(r[case]["decode"],
                                          one["decode"][lo:hi])


@pytest.mark.parametrize("case", CASES)
def test_cache_holds_the_local_kv_heads_where_heads_split_whole(runs, case):
    cfg = runs["cases"][case]["cfg"]
    local = case != "split_head"
    want = cfg.n_kv_heads // 2 if local else cfg.n_kv_heads
    assert all(r[case]["cache_heads"] == want
               for r in runs["groups"]["m12"])
    assert runs["one"][case]["cache_heads"] == cfg.n_kv_heads


def test_harness_on_a_model_axis_is_the_one_column_run(runs):
    """The paper's models stay whole (no rule names their leaves): each
    column's ranks do their row's work, and the history equals the run
    on one column bit for bit on every rank, with ``scored_reduce`` in
    every rank's server round."""
    for name, *_ in HARNESS:
        want = runs["one"]["harness"][name]
        for r in runs["groups"]["m12"]:
            got = r["harness"][name]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for k in ("round", "test_loss", "test_acc", "participants"):
                    assert g[k] == w[k], (name, k)
            assert r["scored_calls"][name] == len(want)


def test_what_a_model_axis_does_not_run_raises(runs):
    for r in runs["groups"]["m12"]:
        for what, msg in r["refusals"].items():
            assert "A7" in msg, what
