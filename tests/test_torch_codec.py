"""The port's relocation codec against the JAX package.

* kernel level: the plain versions of ``encode_pack``/``pack_rows``/
  ``decode_rows`` (what the CUDA kernels compute, and what their
  wrappers compute for CPU tensors) equal the JAX oracles
  ``repro.kernels.ref.reloc_*_ref`` bit for bit, and the port's
  ``decode_rows`` equals the JAX Pallas ``decode_rows`` in interpret
  mode;
* row codecs: ``encode_rows`` bytes and manifest tokens equal the
  reference's, for chunks and for every map value kind;
* the backend dispatch rejects a typo'd environment seed at import.

Inputs come from numpy seeds and go through both packages.  Tolerance:
exact equality — every op here moves bytes.  The kernels themselves
are tested on the card by ``test_torch_cuda.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import collections as jcol
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import collections as tcol
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import reloc_codec as trc

SRC = Path(__file__).resolve().parents[1] / "src"

DTYPES = ["float32", "bfloat16", "int32", "uint8", "float64"]


def _np_dtype(name):
    return np.dtype(ml_dtypes.bfloat16) if name == "bfloat16" \
        else np.dtype(name)


def _torch_mat(a: np.ndarray) -> torch.Tensor:
    """numpy → torch with the same bytes (bf16 through a uint16 view)."""
    if a.dtype == np.dtype(ml_dtypes.bfloat16):
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _u8(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _mat(dtype, m, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1000, 1000, (m, k)) / 7).astype(_np_dtype(dtype))


def _tables(pairs, slots, m, nb, seed):
    """Slot tables with every edge case: live slots, zero-width slots,
    widths below nb, out-of-range and negative row indices."""
    rng = np.random.default_rng(seed)
    n = pairs * slots
    idx = rng.integers(-3, m + 3, n).astype(np.int32)
    wid = np.where(rng.random(n) < 0.6, nb, 0).astype(np.int32)
    wid[::7] = np.minimum(nb, rng.integers(0, nb + 1, len(wid[::7])))
    return idx, wid


# ---------------------------------------------------------------------------
# kernel level: plain versions == JAX oracles
# ---------------------------------------------------------------------------
class TestKernelOracles:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("k,extra", [(3, 0), (3, 1), (5, 2)])
    def test_encode_pack_matches_oracle(self, dtype, k, extra):
        mat = _mat(dtype, 7, k, seed=k)
        nb = k * mat.dtype.itemsize
        W = max(8, 1 << (nb - 1).bit_length()) << extra
        idx, wid = _tables(4, 3, 7, nb, seed=nb + extra)
        # the reference runs x64 off: hand its oracle the rows' bytes
        # (the encode is a byte copy, so this is the same function)
        ref_in = mat.view(np.uint8).reshape(7, nb) \
            if mat.dtype.itemsize == 8 else mat
        want = np.asarray(jref.reloc_encode_pack_ref(
            ref_in, idx, wid, pairs=4, slots=3, width=W))
        for impl in ("fused", "composite"):
            got = tops.reloc_encode_pack(_torch_mat(mat), idx, wid, pairs=4,
                                         slots=3, width=W, impl=impl)
            assert got.shape == (4, 3, W) and got.dtype == torch.uint8
            assert np.array_equal(got.numpy(), want), impl

    def test_encode_pack_rejects_narrow_slots(self):
        mat = torch.zeros((2, 4), dtype=torch.float32)
        with pytest.raises(ValueError):
            tref.reloc_encode_pack_ref(mat, np.zeros(2, np.int32),
                                       np.zeros(2, np.int32), pairs=1,
                                       slots=2, width=8)

    @pytest.mark.parametrize("W", [8, 16, 64])
    def test_pack_rows_matches_oracle(self, W):
        rng = np.random.default_rng(W)
        widths = rng.integers(0, W + 1, 9)
        rows = [rng.integers(0, 256, w).astype(np.uint8) for w in widths]
        arena = np.concatenate(rows + [np.zeros(W, np.uint8)])
        pairs, slots = 4, 4
        offs = np.zeros(pairs * slots, np.int64)
        wids = np.zeros(pairs * slots, np.int32)
        offs[:9] = np.concatenate([[0], np.cumsum(widths)[:-1]])
        wids[:9] = widths
        # the arena's last row, a read past the end (clamped) and a
        # negative offset (clamped to 0)
        offs[10], wids[10] = len(arena) - W, W
        offs[11], wids[11] = len(arena) - 3, W
        offs[12], wids[12] = -5, W
        want = np.asarray(jref.reloc_pack_rows_ref(
            arena, offs.astype(np.int32), wids, pairs=pairs, slots=slots,
            width=W))
        for impl in ("fused", "composite"):
            got = tops.reloc_pack_rows(torch.from_numpy(arena), offs, wids,
                                       pairs=pairs, slots=slots, width=W,
                                       impl=impl)
            assert np.array_equal(got.numpy(), want), impl

    @pytest.mark.parametrize("dtype", ["float32", "int32", "int8",
                                       "uint8"])
    def test_decode_rows_matches_pallas_interpret(self, dtype):
        dt = np.dtype(dtype)
        src = _mat(dtype, 5, 4, seed=11)
        nb = 4 * dt.itemsize
        wire = np.pad(src.view(np.uint8).reshape(5, nb),
                      ((0, 0), (0, 32 - nb)))
        want = np.asarray(jops.reloc_decode_rows(
            wire, nbytes=nb, dtype=dt, impl="pallas_interpret"))
        for impl in ("fused", "composite"):
            got = tops.reloc_decode_rows(torch.from_numpy(wire), nbytes=nb,
                                         dtype=tcol._torch_dtype(dt.str),
                                         impl=impl)
            assert got.numpy().dtype == want.dtype
            assert np.array_equal(got.numpy(), want), impl

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_decode_rows_strided_block(self, dtype):
        # the receiver's block is a slice of the transposed send buffer:
        # a row stride wider than the row, read in place
        mat = _mat(dtype, 6, 3, seed=5)
        nb = 3 * mat.dtype.itemsize
        W = 64
        buf = np.zeros((2, 2, 8, W), np.uint8)
        buf[1, 0, 2:8, :nb] = mat.view(np.uint8).reshape(6, nb)
        recv = torch.from_numpy(buf).transpose(0, 1)
        block = recv[0, 1, 2:8]
        got = tops.reloc_decode_rows(block, nbytes=nb,
                                     dtype=_torch_mat(mat).dtype,
                                     impl="fused")
        assert np.array_equal(_u8(got), mat.view(np.uint8).reshape(6, nb))
        if dtype != "bfloat16" and mat.dtype.itemsize < 8:
            want = np.asarray(jref.reloc_decode_rows_ref(
                block.contiguous().numpy(), nbytes=nb, dtype=mat.dtype))
            assert np.array_equal(got.numpy(), want)

    @pytest.mark.parametrize("seed", range(6))
    def test_roundtrip_encode_then_decode(self, seed):
        rng = np.random.default_rng(seed)
        dtype = DTYPES[seed % len(DTYPES)]
        m, k = int(rng.integers(1, 10)), int(rng.integers(1, 7))
        mat = _mat(dtype, m, k, seed)
        nb = k * mat.dtype.itemsize
        W = max(8, 1 << (nb - 1).bit_length()) << int(rng.integers(0, 3))
        slots = 1 << (m - 1).bit_length()
        idx = np.zeros(slots, np.int32)
        wid = np.zeros(slots, np.int32)
        idx[:m], wid[:m] = np.arange(m), nb
        t = _torch_mat(mat)
        buf = tops.reloc_encode_pack(t, idx, wid, pairs=1, slots=slots,
                                     width=W, impl="fused")
        back = tops.reloc_decode_rows(buf[0, :m], nbytes=nb, dtype=t.dtype,
                                      impl="fused")
        assert back.dtype == t.dtype and torch.equal(
            back.view(torch.uint8), t.view(torch.uint8))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
class TestDispatch:
    def test_set_backend_rejects_typos(self):
        with pytest.raises(ValueError):
            tops.set_backend("fussed")
        assert tops.resolve_backend("fused") == "fused"
        assert tops.resolve_backend("auto", "cpu") == "composite"
        assert tops.resolve_backend("auto", "cuda") == "fused"

    def test_env_seed_rejects_typos_at_import(self):
        env = dict(os.environ, REPRO_TORCH_KERNEL_BACKEND="fussed",
                   PYTHONPATH=str(SRC))
        proc = subprocess.run(
            [sys.executable, "-c", "import repro_torch.kernels.ops"],
            env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "REPRO_TORCH_KERNEL_BACKEND" in proc.stderr

    def test_cpu_tensors_take_the_plain_version(self):
        trc.reset_launch_counts()
        mat = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        trc.encode_pack(mat, np.arange(4, dtype=np.int32) % 3,
                        np.full(4, 16, np.int32), pairs=2, slots=2,
                        width=16)
        # one registry counts every kernel of the port: none launched
        assert set(trc.KERNELS) <= set(trc.launch_counts)
        assert not any(trc.launch_counts.values())


# ---------------------------------------------------------------------------
# row codecs: the port writes the reference's bytes and manifests
# ---------------------------------------------------------------------------
def _pad(row, extra=5):
    row = np.asarray(row, np.uint8)
    return np.concatenate([row, np.zeros(extra, np.uint8)])


class TestRowCodecs:
    @pytest.mark.parametrize("dtype", DTYPES + ["int64", "bool", "int8"])
    @pytest.mark.parametrize("trail", [(), (3,), (2, 2)])
    def test_chunk_encode_rows_match_reference(self, dtype, trail):
        rng = np.random.default_rng(len(trail))
        rows = (rng.integers(-50, 50, (6,) + trail) / 4) \
            .astype(_np_dtype(dtype))
        r = J.LongRange(3, 9)
        ju8, jman = J.DistArray(J.PlaceGroup(2), track=False) \
            .encode_rows((r, rows))
        tcol_ = T.DistArray(T.PlaceGroup(2, device="cpu"), track=False)
        for donate in (False, True):
            tu8, tman = tcol_.encode_rows((T.LongRange(3, 9),
                                           _torch_mat(rows)), donate=donate)
            assert np.array_equal(tu8.numpy(), ju8)
            assert tman[2:] == jman[2:]          # dtype token, trail
            assert (tman[1].start, tman[1].end) == (r.start, r.end)
        raw = tcol_.encode_rows_raw((T.LongRange(3, 9), _torch_mat(rows)))
        assert raw[1][2:] == jman[2:] and raw[0].shape[0] == 6
        padded = torch.from_numpy(np.pad(ju8, ((0, 0), (0, 3))))
        for be in ("fused", "composite"):
            tops.set_backend(be)
            try:
                _, back = tcol_.decode_rows(padded, tman)
            finally:
                tops.set_backend("auto")
            assert back.dtype == _torch_mat(rows).dtype
            assert np.array_equal(_u8(back), _u8(_torch_mat(rows)))

    def test_map_value_kinds_match_reference(self):
        vals = {
            1: np.arange(6, dtype=np.int16).reshape(2, 3),
            2: {"a": np.ones(3, np.float32), "b": [np.zeros(2, np.int64)]},
            3: ("a plain tuple of", 42, "objects"),
            4: np.float64(3.5),
        }
        payload = list(vals.items())
        jrows, jman = J.DistMap(J.PlaceGroup(2)).encode_rows(payload)
        m = T.DistMap(T.PlaceGroup(2, device="cpu"))
        trows, tman = m.encode_rows(payload)
        for a, b in zip(trows, jrows):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        for (tk, ts), (jk, js) in zip(tman[1], jman[1]):
            assert tk == jk and ts[0] == js[0]
            if ts[0] == "tree":
                assert ts[2] == js[2] and ts[3:] == js[3:]
            else:
                assert ts[1:] == js[1:]
        back = dict(m.decode_rows([_pad(r) for r in trows], tman))
        assert np.array_equal(back[1], vals[1]) and back[1].dtype == np.int16
        assert np.array_equal(back[2]["a"], vals[2]["a"])
        assert isinstance(back[2]["b"], list)
        assert back[3] == vals[3]
        assert type(back[4]) is np.float64 and back[4] == 3.5

    def test_numpy_scalars_stay_scalars(self):
        for val in (np.float64(3.5), np.int32(-7), np.bool_(True)):
            row, spec = tcol._encode_value(val)
            jrow, jspec = jcol._encode_value(val)
            assert np.array_equal(row, jrow) and spec == jspec
            back = tcol._decode_value(_pad(row), spec)
            assert type(back) is type(val) and back == val
        tree = {"s": np.float32(2.25), "a": np.ones(2)}
        back = tcol._decode_value(*tcol._encode_value(tree))
        assert type(back["s"]) is np.float32 and back["s"] == tree["s"]

    def test_aliased_leaves_ship_once_and_rebind(self):
        import jax

        page_np = np.arange(16, dtype=np.float32)
        pos_np = np.zeros((1, 1), np.int32)
        page = torch.from_numpy(page_np.copy())
        v = {"k": page, "v": page, "pos": torch.from_numpy(pos_np.copy())}
        row, spec = tcol._encode_value(v)
        assert isinstance(row, torch.Tensor)
        assert int(row.shape[0]) == page.nbytes + 4     # page ships once
        jpage = jax.device_put(page_np)
        jrow, jspec = jcol._encode_value(
            {"k": jpage, "v": jpage, "pos": jax.device_put(pos_np)})
        assert int(jrow.shape[0]) == int(row.shape[0])
        # leaf specs agree up to the device-leaf kind's name
        assert sorted(s[1:] for s in spec[2]) \
            == sorted(s[1:] for s in jspec[2])
        back = tcol._decode_value(torch.cat([row, torch.zeros(7,
                                  dtype=torch.uint8)]), spec)
        assert back["k"] is back["v"]
        assert torch.equal(back["k"], page)
        # the §5.3 accounting counts the shared page once, as the
        # reference does for aliased device leaves
        assert tcol._value_nbytes(v, set()) \
            == jcol._value_nbytes({"k": jpage, "v": jpage,
                                   "pos": pos_np}, set()) == 64 + 4

    def test_payload_nbytes_matches_reference(self):
        page = np.zeros((4, 8), np.float32)
        jm = J.DistMap(J.PlaceGroup(2))
        tm = T.DistMap(T.PlaceGroup(2, device="cpu"))
        jpay = [("a", page), ("b", ("tag", 3, "x")), ("c", np.int64(7))]
        tpay = [("a", page), ("b", ("tag", 3, "x")), ("c", np.int64(7))]
        assert tm._payload_nbytes(tpay) == jm._payload_nbytes(jpay)
        t = torch.from_numpy(page)
        assert tm._payload_nbytes([("a", {"k": t, "v": t})]) \
            == 16 + 8 + page.nbytes

    def test_object_values_fall_back_to_pickle(self):
        obj_arr = np.asarray([("tup", 1), None], dtype=object)
        row, spec = tcol._encode_value(obj_arr)
        assert spec[0] == "pkl"
        back = tcol._decode_value(_pad(row), spec)
        assert back.dtype == object and back[0] == ("tup", 1)
