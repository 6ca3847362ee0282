"""The port's model (qwen2 family, and the dense configs gemma2-27b,
gemma3-12b and phi4-mini-3.8b) against the JAX package.

Both packages start from one JAX ``zoo.init_params(cfg, seed)``: the
port takes it through ``core.interop.params_from_numpy`` (a copy: leaf
paths, shapes and dtypes are the reference's).  Then, on the CPU at the
serving config's size (2 layers, d_model 128, 4 query / 2 KV heads,
head_dim 16):

* the port's ``prefill_forward`` (the flash kernel's plain version) vs
  the JAX package's ``prefill_forward(impl="pallas_interpret")``:
  last logits and every decode-state leaf;
* 8 teacher-forced ``decode_step`` s from those states;
* the port's sequential ``prefill`` vs its ``prefill_forward``;
* ``init_decode_state`` leaf paths, shapes, dtypes and flatten order.
* gemma2-27b, gemma3-12b and phi4-mini-3.8b at ``ModelConfig.reduced()``
  (d_model 64, head_dim 16, window 16; gemma3's one period of 5 local +
  1 global layers) on prompts of 24 tokens, longer than the window:
  prefill logits and every decode-state leaf, then 8 teacher-forced
  decode steps.  In bfloat16 the logits are held at ``3e-2`` and every
  state leaf no further from the float32 run than the JAX package's
  bfloat16 leaf is (x1.5 in relative L2): six layers of bf16 residual
  rounding in two different orders move single cache elements past
  ``3e-2`` in either package, qwen2 at the same depth alike.

Tolerances: float32 compute ``1e-4``; bfloat16 (the config's compute
dtype) ``3e-2``, as ``tests/test_arch_smoke.py`` holds the JAX package's
own prefill and decode paths to each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import Parallel as JParallel
from repro.models import zoo as jzoo
from repro.serving.decode import serving_config as j_serving_config
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import interop
from repro_torch.models import Parallel
from repro_torch.models import attention as TA
from repro_torch.models import transformer as T
from repro_torch.models import zoo
from repro_torch.serving.decode import serving_config

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
S_CACHE = 16


def _paths(tree, prefix=""):
    """(path, shape, dtype name) of every leaf, in flatten order, for a
    tree of either package (None is structure)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], f"{prefix}/{k}")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, x in enumerate(tree):
            out += _paths(x, f"{prefix}/{i}")
        return out
    if tree is None:
        return []
    dt = str(tree.dtype).replace("torch.", "")
    return [(prefix, tuple(tree.shape), dt)]


def _same(a, b) -> bool:
    """Two packages' configs are equal field by field."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    cfg = serving_config()
    assert _same(cfg, j_serving_config())
    jp = jzoo.init_params(cfg, 0)
    tp = interop.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    follow = rng.integers(0, cfg.vocab_size, (8, 2, 1)).astype(np.int32)
    return cfg, jp, tp, tokens, follow


def test_configs_are_the_reference_configs():
    from repro_torch.configs import PORTED

    assert ARCH_IDS == J_ARCH_IDS
    assert PORTED == ("qwen2_1_5b", "gemma2_27b", "gemma3_12b",
                      "phi4_mini_3_8b", "recurrentgemma_2b", "xlstm_350m",
                      "deepseek_v2_lite_16b")
    assert _same(get_config("qwen2-1.5b"), j_get_config("qwen2_1_5b"))
    for name in PORTED:
        assert _same(get_config(name), j_get_config(name))
        assert _same(get_config(name).reduced(), j_get_config(name).reduced())
    assert _same(serving_config(n_layers=3), j_serving_config(n_layers=3))
    for name in ARCH_IDS:
        if name not in PORTED:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                get_config(name)
    with pytest.raises(KeyError):
        get_config("gpt2")


def test_params_carry_across_as_a_copy(setup):
    cfg, jp, tp, _, _ = setup
    assert _paths(tp) == [(p, s, d) for p, s, d in _paths(jp)]
    back = interop.params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the port's own init has the same layout
    own = zoo.init_params(cfg, 3, device="cpu")
    assert _paths(own) == _paths(tp)


def test_init_decode_state_layout_matches(setup):
    cfg = setup[0]
    jst = JT.init_decode_state(cfg, 3, S_CACHE)
    tst = T.init_decode_state(cfg, 3, S_CACHE, device="cpu")
    assert _paths(tst) == _paths(jst)
    # the same flatten order: the row codec lays leaves out in it
    assert [tuple(x.shape) for x in interop.pytree.tree_leaves(tst)] \
        == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jst)]
    for a, b in zip(interop.pytree.tree_leaves(tst),
                    jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(_f32(a), _f32(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(setup, dtype):
    cfg0, jp, tp, tokens, follow = setup
    cfg = dataclasses.replace(cfg0, dtype=dtype)
    tol = TOL[dtype]
    js, jl = JT.prefill_forward(jp, cfg, JParallel(),
                                {"tokens": jnp.asarray(tokens)}, S_CACHE,
                                impl="pallas_interpret")
    ts, tl = T.prefill_forward(tp, cfg, Parallel(),
                               {"tokens": torch.from_numpy(tokens)},
                               S_CACHE, impl="fused")
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=tol)
    assert _paths(ts) == _paths(js)
    for a, b in zip(interop.pytree.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol)
    # the decoded state converts back to the reference's pytree
    assert len(jax.tree_util.tree_leaves(
        interop.decode_state_to_numpy(ts))) == len(
        jax.tree_util.tree_leaves(js))
    for tok in follow:
        js, jl = JT.decode_step(jp, cfg, JParallel(), js, jnp.asarray(tok))
        ts_new, tl = T.decode_step(tp, cfg, Parallel(), ts,
                                   torch.from_numpy(tok))
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=tol)
        ts = ts_new
    for a, b in zip(interop.pytree.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol)


def test_decode_state_from_jax_continues_decode(setup):
    """A JAX decode state carried across decodes like the port's own."""
    cfg0, jp, tp, tokens, follow = setup
    cfg = dataclasses.replace(cfg0, dtype="float32")
    js, _ = JT.prefill_forward(jp, cfg, JParallel(),
                               {"tokens": jnp.asarray(tokens)}, S_CACHE)
    ts = interop.decode_state_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, js), device="cpu")
    _, jl = JT.decode_step(jp, cfg, JParallel(), js, jnp.asarray(follow[0]))
    _, tl = T.decode_step(tp, cfg, Parallel(), ts,
                          torch.from_numpy(follow[0]))
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequential_prefill_matches_parallel_prefill(setup, dtype):
    cfg0, _, tp, tokens, _ = setup
    cfg = dataclasses.replace(cfg0, dtype=dtype)
    tol = TOL[dtype]
    tok = torch.from_numpy(tokens)
    st_seq, lg_seq = T.prefill(tp, cfg, Parallel(), tok, S_CACHE)
    st_par, lg_par = T.prefill_forward(tp, cfg, Parallel(), {"tokens": tok},
                                       S_CACHE)
    np.testing.assert_allclose(_f32(lg_seq[:, -1]), _f32(lg_par),
                               atol=tol, rtol=tol)
    for a, b in zip(interop.pytree.tree_leaves(st_seq),
                    interop.pytree.tree_leaves(st_par)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol)


def test_decode_step_leaves_its_input_state_untouched(setup):
    cfg, _, tp, tokens, follow = setup
    st, _ = T.prefill_forward(tp, cfg, Parallel(),
                              {"tokens": torch.from_numpy(tokens)}, S_CACHE)
    before = [x.clone() for x in interop.pytree.tree_leaves(st)]
    new, _ = T.decode_step(tp, cfg, Parallel(), st,
                           torch.from_numpy(follow[0]))
    for a, b in zip(interop.pytree.tree_leaves(st), before):
        assert torch.equal(a, b)
    assert not torch.equal(new["scan"][0]["pos"], st["scan"][0]["pos"])


def test_cast_params_casts_once(setup):
    cfg, _, tp, _, _ = setup
    cast = T.cast_params(tp, cfg)
    again = T.cast_params(cast, cfg)
    for a, b in zip(interop.pytree.tree_leaves(cast),
                    interop.pytree.tree_leaves(again)):
        assert a is b and a.dtype == torch.bfloat16


def test_ring_cache_of_a_long_prompt_matches_jax():
    """Prompts longer than a sliding-window cache fill it as a ring."""
    from repro.models.config import LayerSlot as JSlot
    from repro_torch.models.config import LayerSlot

    cfg = dataclasses.replace(serving_config(), dtype="float32", window=8,
                              pattern=(LayerSlot("attn_local", "dense"),))
    jcfg = dataclasses.replace(j_serving_config(), dtype="float32",
                               window=8,
                               pattern=(JSlot("attn_local", "dense"),))
    jp = jzoo.init_params(jcfg, 1)
    tp = interop.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    js, jl = JT.prefill_forward(jp, jcfg, JParallel(),
                                {"tokens": jnp.asarray(tokens)}, S_CACHE)
    ts, tl = T.prefill_forward(tp, cfg, Parallel(),
                               {"tokens": torch.from_numpy(tokens)}, S_CACHE)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=1e-4)
    for a, b in zip(interop.pytree.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-4, rtol=1e-4)


def test_attn_decode_matches_jax(setup):
    """The single-call decode (project → write → attend) of one layer."""
    from repro.models import attention as JA

    cfg0, jp, tp, _, _ = setup
    cfg = dataclasses.replace(cfg0, dtype="float32")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([[3], [5]], np.int32)
    ck = rng.standard_normal((2, 8, cfg.n_kv_heads, 16)).astype(np.float32)
    cv = rng.standard_normal((2, 8, cfg.n_kv_heads, 16)).astype(np.float32)
    cpos = np.tile(np.arange(8, dtype=np.int32) - 2, (2, 1))
    layer = lambda p: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a[0], p["scan"][0]["mixer"])
    jo, jk, jv = JA.attn_decode(
        layer(jp), cfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(cpos), window=4)
    to, tk, tv = TA.attn_decode(
        interop.pytree.tree_map(lambda a: a[0],
                                tp["scan"][0]["mixer"]), cfg,
        *(torch.from_numpy(a) for a in (x, pos, ck, cv, cpos)), window=4)
    for a, b in ((to, jo), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5, rtol=1e-5)


def test_unported_pieces_raise():
    with pytest.raises(NotImplementedError, match="distributed"):
        Parallel(mesh=object())
    with pytest.raises(NotImplementedError):
        TA.seq_parallel_decode_attention()
    base = serving_config()
    # MLA and MoE are ported (tests/test_torch_mla.py); these are not
    unported = {
        "enc-dec": dataclasses.replace(base, is_encoder_decoder=True,
                                       encoder_layers=2),
        "mrope": dataclasses.replace(base, mrope_sections=(2, 3, 3)),
        "mtp": dataclasses.replace(base, mtp_depth=1),
    }
    assert unported["enc-dec"].is_encoder_decoder
    for cfg in unported.values():
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            zoo.init_params(cfg, 0, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.init_decode_state(cfg, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# the dense configs: gemma2-27b, gemma3-12b, phi4-mini-3.8b
# ---------------------------------------------------------------------------
DENSE = ("gemma2_27b", "gemma3_12b", "phi4_mini_3_8b")
DENSE_PROMPT = 24       # longer than the reduced window of 16
DENSE_CACHE = 32
BF16_MARGIN = 1.5
_DENSE_RUNS: dict = {}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _dense_run(arch, dtype):
    """Both packages' prefill + 8 decode steps of one reduced config, from
    one JAX parameter draw: (jax logits, port logits, jax leaves, port
    leaves, jax state, port state), each logits array stacked prefill
    first."""
    key = (arch, dtype)
    if key not in _DENSE_RUNS:
        jcfg = dataclasses.replace(j_get_config(arch).reduced(), dtype=dtype)
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
        assert _same(cfg, jcfg)
        jp = jzoo.init_params(jcfg, 0)
        tp = interop.params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        rng = np.random.default_rng(DENSE.index(arch))
        tokens = rng.integers(0, cfg.vocab_size,
                              (2, DENSE_PROMPT)).astype(np.int32)
        follow = rng.integers(0, cfg.vocab_size, (8, 2, 1)).astype(np.int32)
        js, jl = JT.prefill_forward(jp, jcfg, JParallel(),
                                    {"tokens": jnp.asarray(tokens)},
                                    DENSE_CACHE, impl="pallas_interpret")
        ts, tl = T.prefill_forward(tp, cfg, Parallel(),
                                   {"tokens": torch.from_numpy(tokens)},
                                   DENSE_CACHE, impl="fused")
        assert _paths(ts) == _paths(js)
        leaves = ([_f32(x) for x in jax.tree_util.tree_leaves(js)],
                  [_f32(x) for x in interop.pytree.tree_leaves(ts)])
        jls, tls = [_f32(jl)], [_f32(tl)]
        for tok in follow:
            js, jl = JT.decode_step(jp, jcfg, JParallel(), js,
                                    jnp.asarray(tok))
            ts, tl = T.decode_step(tp, cfg, Parallel(), ts,
                                   torch.from_numpy(tok))
            jls.append(_f32(jl))
            tls.append(_f32(tl))
        leaves[0].extend(_f32(x) for x in jax.tree_util.tree_leaves(js))
        leaves[1].extend(_f32(x) for x in interop.pytree.tree_leaves(ts))
        _DENSE_RUNS[key] = (np.stack(jls), np.stack(tls), leaves[0],
                            leaves[1], js, ts)
    return _DENSE_RUNS[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_prefill_and_decode_match_jax(arch, dtype):
    jl, tl, jleaves, tleaves, _, _ = _dense_run(arch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(tl, jl, atol=tol, rtol=tol)
    assert len(tleaves) == len(jleaves)
    if dtype == "float32":
        for a, b in zip(tleaves, jleaves):
            np.testing.assert_allclose(a, b, atol=tol, rtol=tol)
        return
    jl32, _, jleaves32, _, _, _ = _dense_run(arch, "float32")
    assert _rel(tl, jl32) <= BF16_MARGIN * _rel(jl, jl32)
    for a, b, truth in zip(tleaves, jleaves, jleaves32):
        if a.dtype.kind == "f" and np.abs(truth).max() > 0:
            assert _rel(a, truth) <= BF16_MARGIN * max(_rel(b, truth),
                                                       1e-3), (a, b)
        else:
            np.testing.assert_array_equal(a, b)


def test_gemma2_ring_cache_of_a_prompt_longer_than_its_window():
    """gemma2's local layers keep a ring of ``window`` slots: the prompt
    of 24 fills slots ``pos % 16`` with its last 16 positions, and 8
    decode steps go on overwriting the oldest; global layers keep every
    position."""
    cfg = get_config("gemma2_27b").reduced()
    assert cfg.window == 16 < DENSE_PROMPT
    _, _, _, _, js, ts = _dense_run("gemma2_27b", "float32")
    local, glob = ts["scan"][0], ts["scan"][1]
    assert [s.mixer for s in cfg.pattern] == ["attn_local", "attn_global"]
    assert tuple(local["k"].shape[2:3]) == (cfg.window,)
    end = DENSE_PROMPT + 8
    want = np.arange(end - cfg.window, end)
    want = want[np.argsort(want % cfg.window)]
    for b in range(2):
        np.testing.assert_array_equal(local["pos"][0, b].numpy(), want)
        np.testing.assert_array_equal(glob["pos"][0, b].numpy(),
                                      np.arange(DENSE_CACHE))
    for a, b in zip(interop.pytree.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_runs_unchanged_through_the_port(arch):
    """The published config passes the port's support check as it is,
    and its layer slots give the flash launches ``chip_smoke.py``
    counts per fused prefill."""
    cfg = get_config(arch)
    T._check_supported(cfg)
    slots = [s.mixer for s in cfg.layer_slots()]
    assert set(slots) <= {"attn_local", "attn_global"}
    assert len(slots) == {"gemma2_27b": 46, "gemma3_12b": 48,
                          "phi4_mini_3_8b": 32}[arch]
