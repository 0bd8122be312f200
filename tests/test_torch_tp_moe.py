"""The MoE decoders over a 'model' axis on the CPU: expert parallelism,
MLA and MTP tensor-parallel. gloo ranks on (1, 2), (2, 2) and, to compare
with, (2, 1) meshes (``tests/torch_tp_moe_ranks.py`` holds what each rank
runs), against the reference's forward, gradient and exact_tp step on the
same numpy weights (one device, one client) and against the port's own
run on one column.

Cases, all f32 (compute and parameters):
  * ``arctic``: reduced arctic-480b, 2 MoE layers of 4 experts (2 a
    column), GQA on whole heads, and its dense residual MLP, whose stacked
    3-d leaves take the expert rule and are split along their 2 layers;
  * ``deepseek``: reduced deepseek-v3-671b with 3 layers (1 dense, 2 MoE
    with a shared expert split the same way), MLA on whole heads (2 of 4
    a column, the latent cache whole) and MTP;
  * ``experts3``: that deepseek with 3 experts: E % M != 0, so the
    experts stay whole and every column runs all of them;
  * ``heads3``: that deepseek with 3 heads: MLA's split falls inside a
    head, so its split leaves are gathered and every column runs every
    head.

Tolerances: logits, aux and losses, gradients and new parameters within
rtol 1e-4 of the reference's or the one-column run's, each leaf with an
absolute floor of 1e-4 of its largest magnitude (the model axis's sums
add in another order). No routing flip: every MoE call's expert ids are
the one-column run's on every rank. Greedy tokens are equal, and the
latent cache is the one-column run's. Whole leaves' gradients and new
values are the same bits on every column of a row.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_get, tree_paths
from repro_torch.launch import sharding
from repro_torch.models import transformer
from test_torch_moe import _draw_like
from test_torch_oracle import reference, to_numpy_tree  # noqa: F401
from test_torch_tp import (_Axis, _mesh, _row_ranks, _trees_close,
                           _unshard)
import torch_tp_moe_ranks
import torch_tp_ranks as ranks

RTOL = 1e-4
# (name, ranks, model columns, whether the ranks run the FL harness)
GROUPS = (("m12", 2, 2, False), ("m22", 4, 2, False), ("m21", 2, 1, False))
CASES = ("arctic", "deepseek", "experts3", "heads3")
STEPS = ("exact_tp", "exact_tp_sketch", "fedavg")


def _configs(reference):
    """(name, reference config, port config) of each case, f32."""
    out = []
    for name, arch, kw, moe_kw in (
            ("arctic", "arctic-480b", {}, {}),
            ("deepseek", "deepseek-v3-671b", dict(n_layers=3), {}),
            ("experts3", "deepseek-v3-671b", {}, dict(num_experts=3)),
            ("heads3", "deepseek-v3-671b", dict(n_heads=3, n_kv_heads=3),
             {})):
        pair = []
        for c in (reference.configs.get_config(arch).reduced(),
                  get_config(arch).reduced()):
            c = dataclasses.replace(c, dtype="float32",
                                    param_dtype="float32", **kw)
            if moe_kw:
                c = dataclasses.replace(
                    c, moe=dataclasses.replace(c.moe, **moe_kw))
            pair.append(c)
        out.append((name, *pair))
    return out


def _case(reference, name, jc, tc, seed):
    w = _draw_like(lambda: reference.transformer.init_model(
        jax.random.PRNGKey(0), jc), seed)
    tok = np.random.default_rng(seed).integers(0, tc.vocab_size,
                                               size=(4, 17))
    return {"name": name, "cfg": tc, "weights": w, "seed": seed,
            "batch": {"tokens": tok[:, :-1].astype(np.int32),
                      "labels": tok[:, 1:].astype(np.int32)}}


def _reference_runs(reference, cases, jcs):
    """The reference's logits, aux loss, loss, gradient and exact_tp step
    of each case, one client on a one-device mesh (its lambda is 1, so
    the step is also the fedavg step); its greedy prefill token is the
    last position's argmax."""
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    R, T = reference.pod, reference.transformer

    def one(case):
        jc = jcs[case["name"]]
        w = case["weights"]
        b = {k: jnp.asarray(x) for k, x in case["batch"].items()}
        step = R.make_tp_train_step(
            jc, reference.base.FLConfig(num_clients=1, **ranks.FL), mesh)

        def run(p, bb):
            logits = T.forward(p, {"tokens": bb["tokens"]}, jc)[0]
            aux = T.forward(p, bb, jc)[1]
            loss, grads = jax.value_and_grad(
                lambda q: R.loss_fn(q, bb, jc)[0])(p)
            return logits, aux, loss, grads, step(p, bb)
        logits, aux, loss, grads, (new, metrics) = jax.jit(run)(w, b)
        logits = np.asarray(logits)
        stepped = {"params": to_numpy_tree(new),
                   "metrics": {k: float(v) for k, v in metrics.items()}}
        return {"logits": logits, "aux": float(aux), "loss": float(loss),
                "grads": to_numpy_tree(grads), "exact_tp": stepped,
                "fedavg": {"params": stepped["params"],
                           "metrics": {"loss": stepped["metrics"]["loss"]}},
                "prefill": np.argmax(logits[:, -1], axis=-1)}
    # two cases compile at once (the ranks run meanwhile)
    with ThreadPoolExecutor(2) as pool:
        return dict(zip([c["name"] for c in cases], pool.map(one, cases)))


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    configs = _configs(reference)
    cases = [_case(reference, name, jc, tc, seed)
             for seed, (name, jc, tc) in enumerate(configs)]
    jcs = {name: jc for name, jc, _ in configs}
    payload = {"cases": cases}

    def meanwhile():
        before = torch.get_num_threads()
        try:
            one = torch_tp_moe_ranks.run_cases(payload, 1)
        finally:
            torch.set_num_threads(before)
        return one, _reference_runs(reference, cases, jcs)
    groups, (one, ref) = ranks.spawn(GROUPS, payload,
                                     tmp_path_factory.mktemp("tp_moe"),
                                     meanwhile=meanwhile,
                                     job=torch_tp_moe_ranks.run_cases)
    return {"cases": {c["name"]: c for c in cases}, "groups": groups,
            "one": one, "ref": ref}


def _logits(rows: list, cfg, name: str) -> np.ndarray:
    parts = [r[name]["logits"] for r in rows]
    if transformer.vocab_split(cfg, _Axis(len(rows))):
        return np.concatenate(parts, axis=-1)
    return parts[0]


def _specs(cfg, shape: dict):
    return sharding.param_shardings(transformer.init_model(None, cfg),
                                    _mesh(shape))


def test_the_cases_split_as_they_say(runs):
    """Experts by E, the shared expert and the dense residual by layer,
    MLA's leaves on or inside heads, and the router, ``wq_a``, ``wkv_a``
    and MTP's ``proj`` whole."""
    shape = {"data": 1, "model": 2}
    spec = {name: _specs(runs["cases"][name]["cfg"], shape)
            for name in CASES}

    def at(name, *path):
        return tree_get(spec[name], path).spec
    assert at("arctic", "moe_layers", "moe", "w_up") == (
        None, "model", None, None)
    assert at("arctic", "moe_layers", "moe", "dense_residual", "w_up") == (
        "model", None, None)
    assert at("deepseek", "moe_layers", "moe", "shared", "w_down") == (
        "model", None, None)
    assert at("experts3", "moe_layers", "moe", "w_up") == (
        None, None, None, None)
    for name in ("deepseek", "heads3"):
        assert at(name, "dense_layers", "attn", "wq_b") == (
            None, None, "model")
        assert at(name, "mtp", "proj") == (None, None)
        for leaf in ("wq_a", "wkv_a"):
            assert at(name, "dense_layers", "attn", leaf) == (
                None, None, None)
    assert at("deepseek", "moe_layers", "moe", "router") == (
        None, None, None)


@pytest.mark.parametrize("case", CASES)
def test_forward_loss_and_aux_match_the_reference(runs, case):
    cfg = runs["cases"][case]["cfg"]
    rows = runs["groups"]["m12"]
    ref = runs["ref"][case]
    np.testing.assert_allclose(_logits(rows, cfg, case), ref["logits"],
                               rtol=RTOL, atol=RTOL * np.abs(
                                   ref["logits"]).max())
    for r in rows:
        np.testing.assert_allclose(r[case]["loss"], ref["loss"], rtol=RTOL)
        np.testing.assert_allclose(r[case]["aux"], ref["aux"], rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_no_route_flips_on_any_rank(runs, case):
    """Every MoE call of the forward routes as it does on one column: the
    (1, 2) ranks as the one-column run of the whole batch, each (2, 2)
    rank as the (2, 1) rank of its row (a row's capacity is its own
    block's, so its later layers' inputs are its own)."""
    one = runs["one"][case]["routes"]
    assert one
    pairs = [(r, one) for r in runs["groups"]["m12"]] + [
        (r, runs["groups"]["m21"][r["row"]][case]["routes"])
        for r in runs["groups"]["m22"]]
    for r, want in pairs:
        got = r[case]["routes"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_the_reference_and_the_one_column_run(runs, case):
    """Every leaf, the router's and MLA's ``wq_a``/``wkv_a`` among them."""
    cfg = runs["cases"][case]["cfg"]
    got = _unshard(runs["groups"]["m12"], "grads", cfg, lambda r: r[case])
    _trees_close(got, runs["one"][case]["grads"])
    _trees_close(got, runs["ref"][case]["grads"])
    names = {p[-1] for p in tree_paths(got)}
    assert "router" in names
    if cfg.attention == "mla":
        assert {"wq_a", "wkv_a", "proj"} <= names


@pytest.mark.parametrize("group", ("m12", "m22"))
@pytest.mark.parametrize("case", CASES)
def test_whole_leaves_are_the_same_bits_on_every_column(runs, case, group):
    cfg = runs["cases"][case]["cfg"]
    rows = runs["groups"][group]
    specs = _specs(cfg, rows[0]["shape"])
    whole = [p for p in tree_paths(specs)
             if "model" not in tree_get(specs, p).spec]
    assert any(p[-1] == "router" for p in whole)
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


@pytest.mark.parametrize("case", CASES)
def test_prefill_decode_and_the_cache(runs, case):
    """Greedy prefill tokens: (1, 2)'s are the reference's, and each (2, 2)
    row's those of its (2, 1) row (a row block's capacity is its own, so
    its drops are too). Decode routes one token a sequence a step, with
    nothing dropped: every rank's tokens are the one-column run's, and
    its cache (MLA's latent cache, whole on every column) holds the
    one-column run's numbers."""
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
    for group in ("m12", "m22", "m21"):
        for r in runs["groups"][group]:
            lo = 2 * r["row"] if group != "m12" else 0
            hi = lo + (2 if group != "m12" else 4)
            np.testing.assert_array_equal(r[case]["decode"],
                                          one["decode"][lo:hi])
            if cfg.attention != "mla":
                continue
            for path in tree_paths(one["cache"]):
                want = tree_get(one["cache"], path)[:, lo:hi]
                np.testing.assert_allclose(
                    tree_get(r[case]["cache"], path), want, rtol=RTOL,
                    atol=RTOL * np.abs(want).max(), err_msg=str(path))


def test_init_shards_draws_the_whole_trees_shards(runs):
    """``sharding.init_shards`` (a leaf drawn whole, cut, freed) gives each
    rank the bits ``shard_params`` cuts from ``init_model``'s whole tree."""
    for group in ("m12", "m22"):
        for r in runs["groups"][group]:
            for case in CASES:
                assert r[case]["init_shards_equal"], (group, case)
