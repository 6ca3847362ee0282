"""The port's training slice against the JAX package.

Every model case starts from one JAX ``zoo.init_params`` carried across
with ``core.interop.params_from_numpy``, at the serving config's size
(qwen2's family: 2 layers, d_model 128, 4 query / 2 KV heads, head_dim
16, vocab 1024) with ``loss_chunk`` 8 dividing the 24-token rows, in
float32 compute.  On the CPU the port's ``fused`` attention is the
``FlashAttention`` autograd function over the kernels' plain versions
(``flash_ref`` forward, ``flash_bwd_ref`` backward), ``composite`` is
autograd through ``flash_ref``; the JAX package runs ``impl="xla"``.

* ``train_loss`` and its metrics against the reference's;
* every gradient leaf against ``jax.grad`` of the same loss (``remat``
  none, full and dots);
* ``adamw_update`` with float32, bfloat16 and int8 moments (state
  carried across with ``interop.opt_state_from_numpy``), and
  ``cosine_lr``;
* ``build_train_step`` for 3 steps at ``accum`` 1 and 2 with ``remat``
  none and full against the reference's jitted step;
* ``TokenSource`` rows bit for bit; ``ShardedBatches.local_batch`` and
  ``apply_balance`` under a ``StragglerMitigator`` fed uneven step times;
* a checkpoint written by each package restored by the other, and a
  shard with a flipped bit or a compressed member refused on restore.

Tolerances: float32 loss ``1e-5`` relative; gradient leaves ``1e-4`` in
relative L2 (the packages sum in another order).  One leaf is held to
the tree's scale instead: the key projection's bias, whose exact
gradient is 0 (it adds ``q . b`` to every score of a row, which the
softmax cancels), so both packages return rounding noise there; its
difference must stay under ``1e-4`` of the whole gradient's norm.  For
the same reason the train-step comparison leaves that bias out of the
parameter check: AdamW's first steps turn its noise into ``~lr`` sized
moves of either sign.  AdamW: parameters ``1e-6`` relative, f32
moments ``1e-6`` of the leaf's largest value (``b1 m + (1 - b1) g``
cancels where the two differ in sign, so a one-ulp difference of the
clip scale shows larger relatively), bf16 moments within one bf16 ulp,
int8 codes within one step of 127ths (a value on a rounding edge may
round either way) with equal scales to ``1e-6``.  Data pipeline and checkpoints: exact.
"""
import dataclasses
import io
import json
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import PlaceGroup as JPlaceGroup
from repro.data import ShardedBatches as JShardedBatches
from repro.data import TokenSource as JTokenSource
from repro.data import make_global_batch as j_make_global_batch
from repro.models import Parallel as JParallel
from repro.models import zoo as jzoo
from repro.optim import adamw as jadamw
from repro.runtime import StragglerMitigator as JStragglerMitigator
from repro.train.step import build_train_step as j_build_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import PlaceGroup, interop
from repro_torch.data import ShardedBatches, TokenSource, make_global_batch
from repro_torch.models import Parallel
from repro_torch.models import transformer as T
from repro_torch.models import zoo
from repro_torch.optim import adamw
from repro_torch.runtime import StragglerMitigator
from repro_torch.serving.decode import serving_config
from repro_torch.train import build_train_step

LOSS_RTOL = 1e-5
GRAD_RL2 = 1e-4
B, S = 2, 24
ZERO_GRAD_LEAF = "/mixer/wk/b"       # see the module docstring


def _cfg(**kw):
    return dataclasses.replace(serving_config(), dtype="float32",
                               loss_chunk=8, **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    jp = jzoo.init_params(cfg, 0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, B, S)).astype(np.int32)
    labels = np.concatenate([tokens[..., 1:], tokens[..., :1]], axis=-1)
    mask = (rng.random((2, B, S)) > 0.2).astype(np.float32)
    return cfg, jax.tree_util.tree_map(np.asarray, jp), tokens, labels, mask


def _port_params(cfg, npp):
    return interop.params_from_numpy(cfg, npp, device="cpu")


def _leaves_with_paths(tree, prefix=""):
    """(path, leaf) in sorted-key order, for a tree of either package."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_paths(tree[k], f"{prefix}/{k}")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, x in enumerate(tree):
            out += _leaves_with_paths(x, f"{prefix}/{i}")
        return out
    return [] if tree is None else [(prefix, tree)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return interop.tensor_to_numpy(x)
    return np.asarray(x)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(tokens, labels, mask, i=0):
    return {"tokens": tokens[i], "labels": labels[i], "mask": mask[i]}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["fused", "composite"])
def test_train_loss_and_metrics_match_jax(setup, impl):
    cfg, npp, tokens, labels, mask = setup
    batch = _batch(tokens, labels, mask)
    jl, jm = JT.train_loss(jax.tree_util.tree_map(jnp.asarray, npp), cfg,
                           JParallel(), jax.tree_util.tree_map(
                               jnp.asarray, batch), impl="xla")
    tl, tm = T.train_loss(_port_params(cfg, npp), cfg, Parallel(),
                          _torch_batch(batch), impl=impl)
    assert set(tm) == set(jm) == {"loss", "lm_loss", "moe_aux", "router_z"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-12)
    # without labels both shift the tokens and pad with 0
    nl = {"tokens": tokens[1]}
    jl2, _ = JT.train_loss(jax.tree_util.tree_map(jnp.asarray, npp), cfg,
                           JParallel(), {"tokens": jnp.asarray(tokens[1])},
                           impl="xla")
    tl2, _ = T.train_loss(_port_params(cfg, npp), cfg, Parallel(),
                          _torch_batch(nl), impl=impl)
    np.testing.assert_allclose(float(tl2), float(jl2), rtol=LOSS_RTOL)


def _jax_grads(cfg, npp, batch):
    def loss(p):
        return JT.train_loss(p, cfg, JParallel(), batch, impl="xla")[0]
    g = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, npp))
    return jax.tree_util.tree_map(np.asarray, g)


def _port_grads(cfg, npp, batch, impl):
    tp = _port_params(cfg, npp)
    leaves, spec = interop.pytree.tree_flatten(tp)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = T.train_loss(tp, cfg, Parallel(), _torch_batch(batch),
                           impl=impl)
    grads = torch.autograd.grad(loss, leaves)
    return interop.pytree.tree_unflatten(list(grads), spec)


def _check_grads(tg, jg):
    tl, jl = _leaves_with_paths(tg), _leaves_with_paths(jg)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    total = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                        for _, g in jl))
    for (path, a), (_, b) in zip(tl, jl):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape and np.isfinite(a).all(), path
        if path.endswith(ZERO_GRAD_LEAF):
            diff = np.linalg.norm(a.astype(np.float64) - b)
            assert diff <= GRAD_RL2 * total, (path, diff, total)
        else:
            assert _rel_l2(a, b) <= GRAD_RL2, (path, _rel_l2(a, b))


@pytest.mark.parametrize("impl,remat", [("fused", "none"), ("fused", "full"),
                                        ("fused", "dots"),
                                        ("composite", "none")])
def test_every_gradient_leaf_matches_jax_grad(setup, impl, remat):
    cfg0, npp, tokens, labels, mask = setup
    cfg = dataclasses.replace(cfg0, remat=remat)
    batch = _batch(tokens, labels, mask)
    jg = _jax_grads(cfg, npp, jax.tree_util.tree_map(jnp.asarray, batch))
    _check_grads(_port_grads(cfg, npp, batch, impl), jg)


def test_remat_recomputes_the_flash_forward(setup):
    """Under ``remat="full"`` the backward reruns each period's forward:
    the flash forward runs twice per layer, its backward once."""
    cfg0, npp, tokens, labels, mask = setup
    calls = {"fwd": 0, "bwd": 0}
    from repro_torch.kernels import flash_attention as fa
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def count_fwd(*a, **kw):
        calls["fwd"] += kw["with_lse"]
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    batch = _batch(tokens, labels, mask)
    try:
        fa.flash_attention_fwd, fa.flash_attention_bwd = count_fwd, count_bwd
        for remat, want in (("none", 1), ("full", 2)):
            calls.update(fwd=0, bwd=0)
            _port_grads(dataclasses.replace(cfg0, remat=remat), npp, batch,
                        "fused")
            assert calls == {"fwd": want * cfg0.n_layers,
                             "bwd": cfg0.n_layers}, (remat, calls)
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd


def test_train_loss_refuses_unported_branches(setup):
    cfg = setup[0]
    for bad in (dataclasses.replace(cfg, mtp_depth=1),
                dataclasses.replace(cfg, remat="sometimes")):
        with pytest.raises((NotImplementedError, ValueError)):
            tp = zoo.init_params(_cfg(), 0, device="cpu")
            T.train_loss(tp, bad, Parallel(),
                         {"tokens": torch.zeros((1, 8), dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_train_step(cfg, Parallel(mesh=object()))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _opt_tree(rng):
    """A parameter-shaped tree: matrices, a vector and a stacked leaf
    whose size is no multiple of the int8 block."""
    return {"a": {"w": rng.standard_normal((40, 24)).astype(np.float32),
                  "b": rng.standard_normal((24,)).astype(np.float32)},
            "scan": ({"w": rng.standard_normal((3, 17, 9))
                      .astype(np.float32)},)}


def _ulp_bf16(x):
    return np.maximum(np.abs(x), 1e-30) * 2.0 ** -7


def _check_moments(tm, jm, moments):
    for (path, a), (_, b) in zip(_leaves_with_paths(tm),
                                 _leaves_with_paths(jm)):
        a, b = _np(a), np.asarray(b)
        if moments == "int8" and path.endswith("/q"):
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() \
                <= 1, path
        elif moments == "bfloat16":
            a32 = a.view(np.uint16).astype(np.uint32) << 16
            b32 = np.asarray(b.astype(np.float32))
            a32 = a32.view(np.float32)
            assert (np.abs(a32 - b32) <= _ulp_bf16(b32)).all(), path
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=path)


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_jax(moments):
    rng = np.random.default_rng(1)
    params = _opt_tree(rng)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                              moments_dtype=moments, q_block=64)
    tcfg = adamw.AdamWConfig(**dataclasses.asdict(jcfg))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jadamw.adamw_init(jp, jcfg)
    tp = interop.pytree.tree_map(lambda x: torch.from_numpy(x.copy()),
                                 params)
    ts = adamw.adamw_init(tp, tcfg)
    _check_moments(ts["m"], js["m"], moments)
    for i in range(3):
        g = jax.tree_util.tree_map(lambda x: np.asarray(
            rng.standard_normal(x.shape) * (i + 1), np.float32), params)
        jp, js, jmet = jadamw.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), js, jp, jcfg)
        tp, ts, tmet = adamw.adamw_update(
            interop.pytree.tree_map(torch.from_numpy, g), ts, tp, tcfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-6)
        for (path, a), (_, b) in zip(_leaves_with_paths(tp),
                                     _leaves_with_paths(jp)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=path)
        _check_moments(ts["m"], js["m"], moments)
        _check_moments(ts["v"], js["v"], moments)
        assert int(ts["count"]) == int(js["count"]) == i + 1
    # the reference's state carried across continues the same way
    carried = interop.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    assert int(carried["count"]) == 3
    back = interop.opt_state_to_numpy(carried)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(js)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    g = jax.tree_util.tree_map(lambda x: np.asarray(
        rng.standard_normal(x.shape), np.float32), params)
    tp2 = interop.pytree.tree_map(
        lambda x: torch.from_numpy(np.array(x)), jax.tree_util.tree_map(
            np.asarray, jp))
    jp, js, _ = jadamw.adamw_update(jax.tree_util.tree_map(jnp.asarray, g),
                                    js, jp, jcfg)
    tp2, carried, _ = adamw.adamw_update(
        interop.pytree.tree_map(torch.from_numpy, g), carried, tp2, tcfg)
    for (path, a), (_, b) in zip(_leaves_with_paths(tp2),
                                 _leaves_with_paths(jp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=path)


def test_adamw_update_is_in_place():
    params = interop.pytree.tree_map(torch.from_numpy,
                                     _opt_tree(np.random.default_rng(2)))
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    state = adamw.adamw_init(params, cfg)
    ptrs = [x.data_ptr() for x in interop.pytree.tree_leaves((params,
                                                              state["m"]))]
    grads = interop.pytree.tree_map(torch.ones_like, params)
    p2, s2, _ = adamw.adamw_update(grads, state, params, cfg)
    assert [x.data_ptr() for x in interop.pytree.tree_leaves(
        (p2, s2["m"]))] == ptrs


def test_cosine_lr_matches_jax():
    for kw in ({}, {"warmup_steps": 0}, {"warmup_steps": 7,
                                         "total_steps": 20,
                                         "min_lr_ratio": 0.0}):
        jc = jadamw.AdamWConfig(**kw)
        tc = adamw.AdamWConfig(**kw)
        for step in (0, 1, 3, 7, 50, 99, 100, 101, 5000, 10000, 20000):
            np.testing.assert_allclose(
                float(adamw.cosine_lr(tc, torch.tensor(step))),
                float(jadamw.cosine_lr(jc, jnp.asarray(step))), rtol=1e-6,
                atol=1e-12)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_matches_jax_and_the_loss_falls(setup, accum, remat):
    cfg0, npp, tokens, labels, mask = setup
    cfg = dataclasses.replace(cfg0, remat=remat)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    jopt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    if accum == 1:
        batch = _batch(tokens, labels, mask)
    else:
        batch = {"tokens": tokens, "labels": labels, "mask": mask}
    jstep, _, _ = j_build_train_step(cfg, JParallel(), jopt, accum=accum,
                                     impl="xla")
    tstep, ps, os_ = build_train_step(cfg, Parallel(), opt, accum=accum,
                                      impl="fused")
    assert ps is None and os_ is None
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    js = jadamw.adamw_init(jp, jopt)
    tp = _port_params(cfg, npp)
    ts = adamw.adamw_init(tp, opt)
    losses = []
    for _ in range(3):
        jp, js, jm = jstep(jp, js, jax.tree_util.tree_map(jnp.asarray,
                                                          batch))
        tp, ts, tm = tstep(tp, ts, batch)
        for k in ("loss", "lm_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=GRAD_RL2, err_msg=k)
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0], losses
    for (path, a), (_, b) in zip(_leaves_with_paths(tp),
                                 _leaves_with_paths(jp)):
        if not path.endswith(ZERO_GRAD_LEAF):
            assert _rel_l2(_np(a), np.asarray(b)) <= GRAD_RL2, path


# ---------------------------------------------------------------------------
# data pipeline and straggler mitigation
# ---------------------------------------------------------------------------
def test_token_source_rows_are_the_references_bits():
    for seed, vocab, seq in ((0, 1024, 24), (7, 151936, 4096), (3, 50, 9)):
        tsrc, jsrc = TokenSource(vocab, seq, seed), JTokenSource(vocab, seq,
                                                                 seed)
        for epoch, idx in ((0, 0), (0, 5), (2, 1_000_003)):
            a, b = tsrc.row(epoch, idx), jsrc.row(epoch, idx)
            assert a.dtype == b.dtype == np.int32
            assert a.tobytes() == b.tobytes()
        ta = make_global_batch(tsrc, 1, 10, 3)
        ja = j_make_global_batch(jsrc, 1, 10, 3)
        assert set(ta) == set(ja)
        for k in ja:
            assert ta[k].tobytes() == ja[k].tobytes()


def test_sharded_batches_follow_the_straggler_mitigator():
    src, jsrc = TokenSource(1024, 16, 0), JTokenSource(1024, 16, 0)
    tb = ShardedBatches(PlaceGroup(4, device="cpu"), 16, src)
    jb = JShardedBatches(JPlaceGroup(4), 16, jsrc)
    tm, jm = StragglerMitigator(4, period=2), JStragglerMitigator(4,
                                                                  period=2)
    speed = np.array([1.0, 1.0, 1.0, 3.0])      # place 3 is a straggler
    moved = []
    for step in range(8):
        np.testing.assert_array_equal(tb.loads(), jb.loads())
        for p in range(4):
            a, b = tb.local_batch(p), jb.local_batch(p)
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        times = tb.loads() * speed * 1e-3
        moved.append((tm.observe_and_maybe_rebalance(times, tb),
                      jm.observe_and_maybe_rebalance(times, jb)))
        tb.advance()
        jb.advance()
    assert all(a == b for a, b in moved) and any(a for a, _ in moved)
    assert tm.moves_applied == jm.moves_applied > 0
    assert tb.loads()[3] < 4                    # the straggler shed rows
    assert tb.distribution().items() and str(tb.distribution().items()) \
        == str(jb.distribution().items())


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------
def _ckpt_tree(cfg, npp, moments):
    jopt = jadamw.AdamWConfig(moments_dtype=moments, q_block=64)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    js = jadamw.adamw_init(jp, jopt)
    g = jax.tree_util.tree_map(lambda x: jnp.ones_like(x) * 1e-3, jp)
    jp, js, _ = jadamw.adamw_update(g, js, jp, jopt)
    return jax.tree_util.tree_map(np.asarray, {"params": jp, "opt": js})


def _same_bits(a, b):
    la, lb = _leaves_with_paths(a), _leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = _np(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_checkpoints_restore_across_packages(setup, tmp_path, moments):
    cfg, npp = setup[:2]
    tree = _ckpt_tree(cfg, npp, moments)
    ttree = {"params": interop.params_from_numpy(cfg, tree["params"],
                                                 device="cpu"),
             "opt": interop.opt_state_from_numpy(tree["opt"], device="cpu")}
    # the JAX package writes, the port restores into its own tree
    JCheckpointManager(tmp_path / "j", n_shards=2).save(
        5, jax.tree_util.tree_map(jnp.asarray, tree))
    template = interop.pytree.tree_map(torch.zeros_like, ttree)
    got, manifest = CheckpointManager(tmp_path / "j").restore(template)
    assert manifest["step"] == 5
    _same_bits(got, tree)
    # the port writes, the JAX package restores
    mgr = CheckpointManager(tmp_path / "t", keep=2, n_shards=3)
    for step in (1, 2, 3):
        mgr.save(step, ttree, note="port")
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "step_00000002", "step_00000003"]
    jgot, jman = JCheckpointManager(tmp_path / "t").restore(
        jax.tree_util.tree_map(jnp.zeros_like, tree))
    assert jman["step"] == 3 and jman["meta"] == {"note": "port"}
    _same_bits(jax.tree_util.tree_map(np.asarray, jgot), tree)


def test_checkpoint_refuses_bfloat16_leaves(tmp_path):
    """A bfloat16 leaf saves (as the reference saves it, see below) but
    restores in neither package: the reference's ``np.load`` gives a
    ``|V2`` array that ``astype("bfloat16")`` cannot cast, and the
    port's restore raises where the reference's would."""
    CheckpointManager(tmp_path).save(
        0, {"w": torch.zeros(4, dtype=torch.bfloat16)})
    JCheckpointManager(tmp_path / "j").save(
        0, {"w": jnp.zeros(4, jnp.bfloat16)})
    for d in (tmp_path, tmp_path / "j"):
        with pytest.raises(TypeError, match="ml_dtypes"):
            CheckpointManager(d).restore({"w": torch.zeros(4)})
        with pytest.raises(ValueError, match="No cast function"):
            JCheckpointManager(d).restore(
                {"w": jnp.zeros(4, jnp.bfloat16)})


def _npz_members(path):
    """Each member of a ``np.savez`` file as (npy header, data bytes)."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            raw = zf.read(info.filename)
            fh = io.BytesIO(raw)
            np.lib.format.read_magic(fh)
            np.lib.format.read_array_header_1_0(fh)
            out[info.filename] = (raw[:fh.tell()], raw[fh.tell():])
    return out


@pytest.mark.parametrize("n_shards", [1, 3])
def test_bfloat16_leaf_is_saved_as_the_reference_saves_it(tmp_path,
                                                          n_shards):
    """The reference writes a bfloat16 leaf through ``ml_dtypes``, the
    port from a ``uint16`` view of the same bits: equal manifest leaf
    entries, npy headers (``'<V2'``) and member bytes (whole zip files
    differ by their timestamps)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((7, 5)).astype(ml_dtypes.bfloat16)
    b = rng.standard_normal(4).astype(np.float32)
    JCheckpointManager(tmp_path / "j", n_shards=n_shards).save(
        1, {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    CheckpointManager(tmp_path / "t", n_shards=n_shards).save(
        1, {"w": torch.from_numpy(w.view(np.int16).copy())
            .view(torch.bfloat16), "b": torch.from_numpy(b)})
    jd, td = (tmp_path / x / "step_00000001" for x in "jt")
    jm, tm = (json.loads((d / "manifest.json").read_text())
              for d in (jd, td))
    assert jm["leaves"] == tm["leaves"]
    assert jm["leaves"]["w"]["dtype"] == "bfloat16"
    for i in range(n_shards):
        assert _npz_members(jd / f"shard_{i}.npz") \
            == _npz_members(td / f"shard_{i}.npz")
    assert b"'descr': '<V2'" in _npz_members(td / "shard_0.npz")["w.npy"][0]


@pytest.mark.parametrize("damage", ["flipped_byte", "compressed"])
def test_checkpoint_restore_refuses_a_damaged_shard(tmp_path, damage):
    tree = {"w": torch.arange(4096, dtype=torch.float32).reshape(64, 64),
            "b": torch.ones(64, dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path, n_shards=2)
    shard = mgr.save(3, tree) / "shard_1.npz"
    got, _ = mgr.restore(interop.pytree.tree_map(torch.zeros_like, tree))
    assert all(torch.equal(got[k], tree[k]) for k in tree)
    if damage == "flipped_byte":
        # one bit of the second place's rows of w
        raw = bytearray(shard.read_bytes())
        pos = raw.find(tree["w"][32:].numpy().tobytes())
        assert pos > 0
        raw[pos + 1000] ^= 0x01
        shard.write_bytes(bytes(raw))
        match = "CRC-32"
    else:
        with np.load(shard) as z:
            np.savez_compressed(shard, **dict(z))
        match = "compressed"
    with pytest.raises(zipfile.BadZipFile, match=match):
        mgr.restore(interop.pytree.tree_map(torch.zeros_like, tree))
