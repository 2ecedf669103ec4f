"""The port's recsys zoo, configs, synthetic batches and launcher held to the reference's.

Each recsys model (FM, DIEN, BERT4Rec, BST) at ``smoke_recsys_config``
size: the reference draws the parameters (``jax.random``) and
``interop.recsys_params_from_reference`` carries the same values into the
port; the reference's ``recsys_batch`` (numpy) goes through both, batch 16
for training and 8 for serving, as ``tests/test_smoke_archs.py`` runs
them.  Also: the configs and ``arch_ids()`` field by field, the
``param_specs`` under ``MeshRules`` against the reference's
``PartitionSpec``s (as tuples, at full size: no table is allocated), the
synthetic batches' keys, shapes, dtypes and ranges, the launcher for the
five GNN and recsys archs on the CPU, a reference checkpoint restored by
the port, and one case per trap of the port (GELU's tanh form, the
population-variance layer norm, GRU against AUGRU, ``logaddexp``, FM's
global ids, TF32, BERT4Rec's shared negatives).

Tolerances: scores and embeddings rtol 2e-4, atol 2e-5 (the reference's
GAT tolerance); losses rtol 1e-4; gradients 1e-4 relative L2 per
parameter tensor against ``jax.value_and_grad``, relative to 1% of the
whole gradient's norm where a tensor's own is smaller (a gradient that
is zero in exact arithmetic, as BERT4Rec's ``out_b`` under its softmax,
is rounding noise on both sides).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.data import synth as ref_synth  # noqa: E402
from repro.models import recsys as ref_rec  # noqa: E402
from repro.models.retrieval import retrieval_topk as ref_topk  # noqa: E402
from repro.sharding import axes as ref_axes  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.models import recsys as rec  # noqa: E402
from repro_torch.models.param_tree import ParamTree, tree_of  # noqa: E402
from repro_torch.models.retrieval import retrieval_topk  # noqa: E402
from repro_torch.sharding.axes import MeshRules  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop  # noqa: E402

RECSYS = ["fm", "dien", "bert4rec", "bst"]
GNN_RECSYS = ["gat-cora", *RECSYS]
RTOL, ATOL = 2e-4, 2e-5


def quick_jit(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimisation level
    0, which halves the compile time here; the HLO is the same (LLVM's
    vectorisation may order a sum differently, within rounding)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """One arch at smoke size in both packages, with the reference's
    numbers for the train and serve batches."""

    def __init__(self, arch):
        self.ref_cfg = ref_base.smoke_recsys_config(ref_base.load_arch(arch).config)
        self.cfg = base.smoke_recsys_config(base.load_arch(arch).config)
        init, _, loss, score, qemb, cands = ref_rec.get_model(self.ref_cfg)
        cfg = self.ref_cfg

        def ref_all(key):  # one jit: op by op the reference's init and batches take seconds each here
            p = init(key, cfg)
            train = ref_synth.recsys_batch(key, cfg, 16, train=True)
            serve = ref_synth.recsys_batch(jax.random.fold_in(key, 1), cfg, 8, train=False)
            (lv, metrics), grads = jax.value_and_grad(lambda q: loss(q, train, cfg), has_aux=True)(p)
            q = qemb(p, serve, cfg)
            return p, train, serve, (lv, metrics, grads, score(p, serve, cfg), q, ref_topk(cands(p, cfg, 256), q, k=10))

        self.ref_params, train, serve, out = quick_jit(ref_all, jax.random.PRNGKey(0))
        self.params_np, self.train, self.serve = _np(self.ref_params), _np(train), _np(serve)
        self.model = interop.recsys_params_from_reference(self.params_np, self.cfg, device="cpu")
        self.ref = dict(zip(("loss", "metrics", "grads", "score", "query", "topk"), _np(out)))


_PAIRS = {}


def pair(arch) -> Pair:
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


def test_configs_and_arch_ids_equal_the_references():
    assert base.arch_ids() == ref_base.arch_ids()
    assert set(base.registry()) == set(ref_base.registry())
    for arch in GNN_RECSYS:
        ref_spec, spec = ref_base.load_arch(arch), base.load_arch(arch)
        conv = interop.gnn_config_from_dict if arch == "gat-cora" else interop.recsys_config_from_dict
        assert conv(dataclasses.asdict(ref_spec.config)) == spec.config
        assert spec.config.family == ref_spec.config.family and spec.config.dtype == torch.float32
        assert [(c.name, c.kind, dict(c.dims), c.skip_reason) for c in spec.shapes] == \
            [(c.name, c.kind, dict(c.dims), c.skip_reason) for c in ref_spec.shapes]
        if arch != "gat-cora":
            assert conv(dataclasses.asdict(ref_base.smoke_recsys_config(ref_spec.config))) == \
                base.smoke_recsys_config(spec.config)


@pytest.mark.parametrize("arch", RECSYS)
def test_param_specs_equal_the_references_at_full_size(arch):
    ref_cfg, cfg = ref_base.load_arch(arch).config, base.load_arch(arch).config
    ref_specs_fn, specs_fn = ref_rec.get_model(ref_cfg)[1], rec.get_model(cfg)[1]
    for kw in (dict(), dict(batch=("data",), model="model"), dict(batch=("pod", "data"), model="model")):
        assert specs_fn(cfg, MeshRules(**kw)) == jax.tree.map(tuple, ref_specs_fn(ref_cfg, ref_axes.MeshRules(**kw)))
    init = rec.get_model(cfg)[0]
    shapes = jax.eval_shape(lambda: ref_rec.get_model(ref_cfg)[0](jax.random.PRNGKey(0), ref_cfg))
    meta = init(None, cfg)  # the meta device: shapes only, no table allocated
    assert all(p.device.type == "meta" for p in meta.parameters())
    assert tree_of(meta, lambda p: tuple(p.shape)) == jax.tree.map(lambda s: tuple(s.shape), shapes)


@pytest.mark.parametrize("arch", RECSYS)
def test_init_draws_the_references_distributions(arch):
    p = pair(arch)
    model = rec.get_model(p.cfg)[0](torch.Generator().manual_seed(0), p.cfg)
    assert tree_of(model, lambda t: tuple(t.shape)) == jax.tree.map(lambda a: tuple(a.shape), p.params_np)
    for name, t in model.named_parameters():
        want = interop.by_name(p.params_np, name)
        if not np.any(want):
            assert not torch.any(t), name
        elif t.numel() > 500:  # the same scale: N(0, s²) with the reference's s
            assert np.std(want) == pytest.approx(float(t.detach().std()), rel=0.25), name


@pytest.mark.parametrize("arch", RECSYS)
def test_loss_and_gradients_match_reference(arch):
    p = pair(arch)
    loss_fn = rec.get_model(p.cfg)[2]
    loss, metrics = loss_fn(p.model, _t(p.train), p.cfg)
    np.testing.assert_allclose(loss.item(), float(p.ref["loss"]), rtol=1e-4)
    assert set(metrics) == set(p.ref["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(p.ref["metrics"][k]), rtol=1e-4)
    grads = torch.autograd.grad(loss, list(p.model.parameters()))
    total = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64)) for g in jax.tree.leaves(p.ref["grads"])))
    for (name, _), g in zip(p.model.named_parameters(), grads):
        want = interop.by_name(p.ref["grads"], name)
        err = np.linalg.norm(g.numpy().astype(np.float64) - want)
        assert err <= 1e-4 * max(np.linalg.norm(want), 1e-2 * total), name


@pytest.mark.parametrize("arch", RECSYS)
def test_serving_matches_reference(arch):
    """score, query_embedding, candidate_table and retrieval top-k."""
    p = pair(arch)
    _, _, _, score, qemb, cands = rec.get_model(p.cfg)
    with torch.no_grad():
        s = score(p.model, _t(p.serve), p.cfg)
        q = qemb(p.model, _t(p.serve), p.cfg)
        top = retrieval_topk(cands(p.model, p.cfg, 256), q, k=10)
    assert s.shape == (8,)
    np.testing.assert_allclose(s.numpy(), p.ref["score"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(q.numpy(), p.ref["query"], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(top.ids.numpy(), p.ref["topk"].ids)
    np.testing.assert_allclose(top.scores.numpy(), p.ref["topk"].scores, rtol=RTOL, atol=ATOL)


def test_get_model_returns_the_references_six_in_order():
    for arch in RECSYS:
        cfg = base.load_arch(arch).config
        ours = [f.__name__ for f in rec.get_model(cfg)]
        assert ours == [f.__name__ for f in ref_rec.get_model(ref_base.load_arch(arch).config)]
        assert [n.split("_", 1)[1] for n in ours] == ["init", "param_specs", "loss", "score", "query_embedding",
                                                      "candidate_table"]


def _describe(batch):
    return {k: (tuple(np.shape(v)), str(np.asarray(v).dtype)) for k, v in batch.items()}


def _ranges(cfg, key):
    """[low, high) of a batch entry's values, from the config."""
    if key in ("label", "seq_mask", "pad_mask"):
        return 0, 2
    if key == "ids":
        return 0, np.asarray(cfg.vocab_sizes)[None]
    if key == "masked_pos":
        return 0, cfg.seq_len
    if cfg.interaction == "augru":
        v_item, v_cate, v_user = cfg.vocab_sizes
        return 0, {"profile_ids": v_user, "seq_cates": v_cate, "target_cate": v_cate}.get(key, v_item)
    return 0, cfg.item_vocab


@pytest.mark.parametrize("arch", RECSYS)
@pytest.mark.parametrize("train", [True, False])
def test_recsys_batches_keys_shapes_dtypes_ranges(arch, train):
    p = pair(arch)
    cfg, ref = p.cfg, (p.train if train else p.serve)
    rows = len(next(iter(ref.values()))) if arch != "bert4rec" else ref["seq"].shape[0]
    ours = {k: v.numpy() for k, v in synth.recsys_batch(torch.Generator().manual_seed(0), cfg, rows,
                                                        train=train).items()}
    assert _describe(ours) == _describe(ref)
    for k, v in ours.items():
        lo, hi = _ranges(cfg, k)
        for batch in (ours, ref):  # the bounds hold for the reference's batch too
            assert np.all(batch[k] >= lo) and np.all(batch[k] < hi), k
    for k in ("label", "seq_mask", "pad_mask"):
        if k in ours:
            assert set(np.unique(ours[k])) <= {0.0, 1.0}
    if arch == "dien":  # a prefix mask of length 1..T
        m = ours["seq_mask"]
        assert np.all(np.diff(m, axis=1) <= 0) and np.all(m[:, 0] == 1)


@pytest.mark.parametrize("n_graphs", [0, 6])
def test_gnn_batches_keys_shapes_dtypes(n_graphs):
    kw = dict(n_nodes=60, n_edges=200, d_feat=7, n_classes=3, n_graphs=n_graphs, pad_edges_to=300)
    ref_cfg = ref_base.load_arch("gat-cora").config
    ref = _np(quick_jit(lambda key: ref_synth.gnn_batch(key, ref_cfg, **kw), jax.random.PRNGKey(0)))
    ours = {k: v.numpy() for k, v in synth.gnn_batch(torch.Generator().manual_seed(0),
                                                     base.load_arch("gat-cora").config, **kw).items()}
    assert _describe(ours) == _describe(ref)
    for k in ("edge_mask", "graph_ids", "label_mask"):
        if k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_array_equal(ours["edge_src"][200:260], np.arange(60))
    assert ours["labels"].max() < 3 and ours["edge_src"].max() < 60


@pytest.mark.parametrize("arch", GNN_RECSYS)
def test_launcher_trains_every_gnn_and_recsys_arch_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch <id> --device cpu --steps 2``,
    its ``main`` called in this process."""
    from repro_torch.launch.train import main

    main(["--arch", arch, "--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "device=cpu" in out and "[train] done" in out, out


def test_reference_checkpoint_restored_by_the_port(tmp_path):
    """A smoke DIEN (lists in its tree: ``mlp``) saved by the reference,
    restored into the port's module by parameter name, bitwise."""
    p = pair("dien")
    ref_ckpt.save(tmp_path, 3, {"params": p.ref_params})
    named = loop.named_params(p.model)
    tree, step = ckpt.restore(tmp_path, {"params": named})
    assert step == 3 and set(tree["params"]) == set(named) and "mlp.0.w" in named
    for name, t in tree["params"].items():
        np.testing.assert_array_equal(t.numpy(), interop.by_name(p.params_np, name))


# ---------------------------------------------------------------------------
# Traps
# ---------------------------------------------------------------------------


def test_enc_block_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to approximate=True; the erf form misses the tolerance."""
    rng = np.random.default_rng(0)
    bp_np = {"ln1": rng.standard_normal(16).astype(np.float32) * 0.1,
             "ln2": rng.standard_normal(16).astype(np.float32) * 0.1,
             "wqkv": rng.standard_normal((16, 48)).astype(np.float32) * 0.5,
             "wo": rng.standard_normal((16, 16)).astype(np.float32) * 0.25,
             "w1": rng.standard_normal((16, 64)).astype(np.float32) * 0.5,
             "b1": rng.standard_normal(64).astype(np.float32),
             "w2": rng.standard_normal((64, 16)).astype(np.float32) * 0.25,
             "b2": np.zeros(16, np.float32)}
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    pm = np.ones((3, 7), np.float32)
    pm[1, 5:] = 0.0
    ref = np.asarray(jax.jit(lambda a, q, m: ref_rec._enc_block(a, q, 4, pad_mask=m))(x, bp_np, pm))
    bp = ParamTree(bp_np)
    with torch.no_grad():
        ours = rec._enc_block(torch.from_numpy(x), bp, 4, pad_mask=torch.from_numpy(pm)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
        real = torch.nn.functional.gelu
        try:  # the erf form is detectably different
            torch.nn.functional.gelu = lambda t, approximate="none": real(t)
            erf = rec._enc_block(torch.from_numpy(x), bp, 4, pad_mask=torch.from_numpy(pm)).numpy()
        finally:
            torch.nn.functional.gelu = real
    assert np.max(np.abs(erf - ref) - (ATOL + RTOL * np.abs(ref))) > 0


def test_layernorm_population_variance_and_one_plus_scale():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 10)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(10).astype(np.float32) * 0.2
    ours = rec._layernorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref_rec._layernorm(jnp.asarray(x), jnp.asarray(scale))),
                               rtol=1e-5, atol=1e-6)
    ln = torch.nn.functional.layer_norm(torch.from_numpy(x), (10,), eps=1e-6).numpy() * (1 + scale)
    np.testing.assert_allclose(ours, ln, rtol=1e-5, atol=1e-5)  # unbiased=False, eps 1e-6, (1 + scale)


def test_gru_and_augru_scans_match_reference_with_padding():
    """GRU: (1−z)·n + z·h; AUGRU: (1−a·z)·h + a·z·n; padding steps freeze the state."""
    rng = np.random.default_rng(2)
    b, t, d, h = 3, 6, 5, 4
    w_np = {"wx": rng.standard_normal((d, 3 * h)).astype(np.float32), "wh": rng.standard_normal((h, 3 * h)).astype(np.float32),
            "b": rng.standard_normal(3 * h).astype(np.float32)}
    xs = rng.standard_normal((b, t, d)).astype(np.float32)
    att = rng.random((b, t)).astype(np.float32)
    h0 = rng.standard_normal((b, h)).astype(np.float32)
    mask = (np.arange(t)[None] < np.array([6, 3, 1])[:, None]).astype(np.float32)
    w = ParamTree(w_np)
    jw = jax.tree.map(jnp.asarray, w_np)
    with torch.no_grad():
        for ours, ref in ((rec.gru_scan(w, torch.from_numpy(xs), torch.from_numpy(h0), torch.from_numpy(mask)),
                           ref_rec.gru_scan(jw, jnp.asarray(xs), jnp.asarray(h0), jnp.asarray(mask))),
                          (rec.augru_scan(w, torch.from_numpy(xs), torch.from_numpy(att), torch.from_numpy(h0),
                                          torch.from_numpy(mask)),
                           ref_rec.augru_scan(jw, jnp.asarray(xs), jnp.asarray(att), jnp.asarray(h0), jnp.asarray(mask)))):
            np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(ours[1][2, 1:].numpy(), np.broadcast_to(ours[1][2, 0].numpy(), (t - 1, h)))
        gru = rec.gru_scan(w, torch.from_numpy(xs), torch.from_numpy(h0))[0]
        augru = rec.augru_scan(w, torch.from_numpy(xs), torch.from_numpy(np.ones_like(att)), torch.from_numpy(h0))[0]
    assert not torch.allclose(gru, augru)  # the two updates are not one another


def test_dien_aux_loss_with_large_logits_matches_reference():
    """logaddexp(0, x), not a thresholded softplus, with logits past 20."""
    p = pair("dien")
    params_np = dict(p.params_np, aux_w=p.params_np["aux_w"] * 3000.0, item=p.params_np["item"] * 100.0,
                     cate=p.params_np["cate"] * 100.0)
    model = interop.recsys_params_from_reference(params_np, p.cfg, device="cpu")
    with torch.no_grad():
        _, aux = rec._dien_features(model, _t(p.train), p.cfg)
    _, ref_aux = quick_jit(lambda q, b: ref_rec._dien_features(q, b, p.ref_cfg), params_np, p.train)
    assert float(ref_aux) > 20
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-4)


def test_fm_global_ids_and_candidate_table():
    """Global ids are ids + the fields' offsets in int32 (40.9 M rows at
    full size); the candidate table is the last field's rows."""
    cfg, ref_cfg = base.load_arch("fm").config, ref_base.load_arch("fm").config
    off = rec._fm_offsets(cfg, "cpu")
    assert off.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), np.asarray(ref_rec._fm_offsets(ref_cfg)))
    assert int(off[-1]) + cfg.vocab_sizes[-1] == sum(cfg.vocab_sizes) == 40_894_464
    p = pair("fm")
    got = rec.fm_candidate_table(p.model, p.cfg, 100).detach().numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_rec.fm_candidate_table(p.ref_params, p.ref_cfg, 100)))
    np.testing.assert_array_equal(got, p.params_np["embed"][sum(p.cfg.vocab_sizes[:-1]):][:100])


def test_entry_points_hold_tf32_off(monkeypatch):
    p = pair("bst")
    seen = []
    real = rec._mlp_apply
    monkeypatch.setattr(rec, "_mlp_apply", lambda *a: (seen.append(torch.backends.cuda.matmul.allow_tf32), real(*a))[1])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            rec.bst_score(p.model, _t(p.serve), p.cfg)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == [False]


def test_bert4rec_negatives_do_not_lead_with_the_batch():
    """neg_ids is (min(1024, V),) and shared by the batch; a microbatch
    split cuts it as it cuts the rows, in both packages alike, so the card
    cuts BERT4Rec's batch instead of microbatching it."""
    p = pair("bert4rec")
    assert p.train["neg_ids"].shape == (min(1024, p.cfg.item_vocab),) == (512,)
    parts = loop._split(_t(p.train), 2)
    assert [tuple(x["neg_ids"].shape) for x in parts] == [(256,), (256,)]
    split = jax.tree.map(lambda x: x.reshape(2, x.shape[0] // 2, *x.shape[1:]), p.train)
    np.testing.assert_array_equal(parts[1]["neg_ids"].numpy(), split["neg_ids"][1])
