"""Real-decode data plane: the model behind the elastic driver.

The port of ``repro.serving.decode``.  A :class:`DecodeEngine` runs
``models.transformer.decode_step`` (eagerly — there is no ``jit``; the
compute parameters are drawn in the compute dtype once, at
construction) over each replica's resident sequences in power-of-two
micro-batch buckets and reports *measured* wall-clock step times: the
numbers that feed :class:`~repro_torch.serving.workload.TrafficWorkload`'s
decode EWMA and the GLB's cost exchange.  On the card the timed window
is closed by ``torch.cuda.synchronize()``, as the reference closes it
with ``jax.block_until_ready``.

KV residency: every sequence's cache rows live in a :class:`SeqKV` — a
batch-1 slice of the decode-state pytree whose leaves are tensors on
the group's device, each owning its storage.  Each round the engine
stacks the resident slices into one batch state, runs the step, and
rebinds every ``SeqKV`` to fresh contiguous copies of its slice of the
result (never views into the batch output, which would pin the whole
batch and ship strided bytes).

:class:`RealDecodeSim` is the skewed-cluster harness on top: ``work[p]``
extra decode passes emulate a slow chip (the model really runs ``work``
times, wall-clock measured), Poisson arrivals, and lockstep rounds whose
duration is the slowest live replica's measured time.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import telemetry
from ..models import Parallel, zoo
from ..models import transformer as T
from .cache import SeqKV

__all__ = ["DecodeEngine", "RealDecodeSim", "serving_config"]


def serving_config(*, n_layers: int = 2, d_model: int = 128,
                   d_ff: int = 512, vocab_size: int = 1024):
    """The reduced decoder-only config the serving examples and tests
    run (qwen2's family, cut to size by ``ModelConfig.reduced``)."""
    from ..configs import get_config
    return get_config("qwen2_1_5b").reduced(
        n_layers=n_layers, d_model=d_model, d_ff=d_ff,
        vocab_size=vocab_size)


# ---------------------------------------------------------------------------
# per-sequence state slicing (batch axis differs per state section)
# ---------------------------------------------------------------------------
def _stack_states(states: list) -> dict:
    """Batch-1 decode-state slices → one batch-B state.  ``pos`` /
    ``prefix`` / ``suffix`` leaves carry batch on axis 0; scanned-period
    leaves carry it on axis 1 (axis 0 is the layer period)."""
    cat0 = lambda *xs: torch.cat(xs, dim=0)
    cat1 = lambda *xs: torch.cat(xs, dim=1)
    return {
        "pos": cat0(*[s["pos"] for s in states]),
        "prefix": pytree.tree_map(cat0, *[s["prefix"] for s in states]),
        "scan": pytree.tree_map(cat1, *[s["scan"] for s in states]),
        "suffix": pytree.tree_map(cat0, *[s["suffix"] for s in states]),
    }


def _own(a: torch.Tensor) -> torch.Tensor:
    """A contiguous copy that owns its storage."""
    return a.clone(memory_format=torch.contiguous_format)


def _unstack_state(state: dict, n: int) -> list:
    """Inverse of :func:`_stack_states`: the first ``n`` batch slices,
    each leaf a contiguous tensor of its own."""
    out = []
    for i in range(n):
        out.append({
            "pos": _own(state["pos"][i:i + 1]),
            "prefix": pytree.tree_map(lambda a: _own(a[i:i + 1]),
                                      state["prefix"]),
            "scan": pytree.tree_map(lambda a: _own(a[:, i:i + 1]),
                                    state["scan"]),
            "suffix": pytree.tree_map(lambda a: _own(a[i:i + 1]),
                                      state["suffix"]),
        })
    return out


class DecodeEngine:
    """Lockstep decode over per-sequence device KV slices.

    One engine (model + compute params) is shared by every replica — a
    replica's step is ``decode_batch`` over *its* resident ``SeqKV``
    list.  A replica decodes in micro-batches of at most ``max_batch``
    sequences; overflow runs as additional sequential steps, so a
    replica's measured time grows with its residency — the signal the
    traffic-keyed GLB balances on.  Micro-batches are padded to
    power-of-two buckets (≤ log2(max_batch)+1 shapes); each bucket is
    warmed untimed on first use, since its first launch builds the
    kernels and allocates.

    ``device`` defaults to the CUDA card; with no card the caller must
    ask for the CPU (``device="cpu"``).
    """

    def __init__(self, cfg=None, *, s_cache: int = 128, max_batch: int = 8,
                 seed: int = 0, device=None):
        self.device = zoo.default_device(device)
        self.cfg = cfg if cfg is not None else serving_config()
        if self.cfg.is_encoder_decoder:
            raise ValueError("DecodeEngine serves decoder-only configs")
        self.par = Parallel(mesh=None)
        # compute params, drawn in the compute dtype: the values
        # ``cast_params`` makes of the f32 draw, without ever holding the
        # f32 masters (15.7 B parameters are 63 GB in f32)
        self.params = T.cast_params(zoo.init_params(
            dataclasses.replace(self.cfg, param_dtype=self.cfg.dtype), seed,
            device=self.device), self.cfg)
        self.s_cache = s_cache
        self.max_batch = int(max_batch)
        self.rng = np.random.default_rng(seed)
        # host-side batch-1 template: admission builds SeqKVs from it and
        # the driver bridges them to the group's device (``kv.to_device``)
        self._template = T.init_decode_state(self.cfg, 1, s_cache,
                                             device="cpu")
        self._pad_state = pytree.tree_map(lambda a: a.to(self.device),
                                          self._template)
        self._pad_token = torch.zeros((1, 1), dtype=torch.int32,
                                      device=self.device)
        self._warm: set[int] = set()
        self.steps = 0
        self.tokens_decoded = 0

    def _step(self, state, tokens):
        state, logits = T.decode_step(self.params, self.cfg, self.par,
                                      state, tokens)
        return state, logits.argmax(-1)[:, None].to(torch.int32)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- admission ---------------------------------------------------------
    def new_seq(self, prompt_len: int) -> SeqKV:
        """Fresh host-side :class:`SeqKV`: empty cache, position advanced
        past the prompt, a random start token.  CPU tensors on purpose —
        ``DistMap.to_device`` is the bridge that moves it to the group's
        device."""
        state = pytree.tree_map(torch.clone, self._template)
        state["pos"] = torch.full((1,), int(prompt_len), dtype=torch.int32)
        token = torch.from_numpy(np.asarray(
            self.rng.integers(0, self.cfg.vocab_size, (1, 1)), np.int32))
        return SeqKV(state, token)

    def _bucket(self, n: int) -> int:
        return 1 << max(n - 1, 0).bit_length()

    # -- the measured lockstep step ---------------------------------------
    def decode_batch(self, seq_kvs: list, *, work: int = 1) -> float:
        """One decode step for every sequence in ``seq_kvs`` (each rebound
        to its updated state and token); returns the *measured* seconds
        the model spent.  Sequences beyond ``max_batch`` decode as
        additional sequential micro-batch steps.  ``work`` repeats each
        step that many times (slow-chip emulation: the compute really
        runs) while the sequences still advance a single token."""
        n = len(seq_kvs)
        if n == 0:
            return 0.0
        prepared = []   # (chunk, stacked state, tokens) — built untimed
        for lo in range(0, n, self.max_batch):
            chunk = seq_kvs[lo:lo + self.max_batch]
            bucket = self._bucket(len(chunk))
            pad = bucket - len(chunk)
            state = _stack_states([kv.state for kv in chunk]
                                  + [self._pad_state] * pad)
            tokens = torch.cat([kv.token.to(self.device) for kv in chunk]
                               + [self._pad_token] * pad, dim=0)
            if bucket not in self._warm:   # first launch untimed
                self._step(state, tokens)
                self._sync()
                self._warm.add(bucket)
            prepared.append((chunk, state, tokens))
        # drain the queue (stacking above, unstacking from earlier calls)
        # so the timed window measures *this* decode only
        self._sync()
        with telemetry.span("serve.decode_batch", seqs=n, work=work):
            t0 = time.perf_counter()
            outs = []
            for _, state, tokens in prepared:
                for _ in range(max(int(work), 1)):
                    out = self._step(state, tokens)
                outs.append(out)
            self._sync()
            dt = time.perf_counter() - t0
        if telemetry.enabled():
            telemetry.observe("serve.decode_s", dt)
        for (chunk, _, _), (out_state, out_tokens) in zip(prepared, outs):
            for i, (kv, new_state) in enumerate(
                    zip(chunk, _unstack_state(out_state, len(chunk)))):
                kv.state = new_state
                kv.token = _own(out_tokens[i:i + 1])
        self.steps += 1
        self.tokens_decoded += n
        return dt


# ---------------------------------------------------------------------------
# skewed-cluster harness on the real data plane
# ---------------------------------------------------------------------------
@dataclass
class RealDecodeSim:
    """Lockstep serving rounds against :class:`DecodeEngine`.

    Replica ``p`` runs ``work[p]`` decode passes per round (an honestly
    slow chip); the round's simulated duration is the slowest live
    replica's *measured* time.  ``work_from`` delays the skew.  Pass a
    shared ``engine`` so balanced/unbalanced comparisons reuse one set
    of parameters and warmed buckets.
    """

    n_replicas: int = 4
    slots: int = 16
    work: tuple = ()                 # per-replica decode passes per round
    work_from: int = 0               # round at which the skew activates
    preload: tuple = ()              # (replica, count): hot-shard residency
    preload_max_new: tuple = (48, 64)
    arrival_rate: float = 3.0
    prompt_range: tuple = (8, 48)
    max_new_range: tuple = (8, 24)
    fail_at: dict = field(default_factory=dict)
    glb_period: int = 4
    policy: str = "proportional"
    balance: bool = True
    heartbeat_timeout: int = 2
    pipeline_depth: int = 1      # 2 = double-buffered migration windows
    transport: object = None     # relocation data plane ("host"/"device")
    seed: int = 0
    engine: DecodeEngine | None = None

    def __post_init__(self):
        from ..core import GLBConfig
        from .elastic import ElasticServingDriver
        if self.engine is None:
            self.engine = DecodeEngine()
        period = self.glb_period if self.balance else 10 ** 9
        self.driver = ElasticServingDriver(
            self.n_replicas, slots_per_replica=self.slots,
            glb=GLBConfig(period=period, policy=self.policy, ema=0.3,
                          asynchronous=True,
                          pipeline_depth=self.pipeline_depth),
            heartbeat_timeout=self.heartbeat_timeout,
            engine=self.engine, transport=self.transport)
        if not self.work:
            self.work = (1,) * self.n_replicas
        self.rng = np.random.default_rng(self.seed)
        if self.preload:
            # skewed residency: long-lived sequences pinned to one replica
            # — spreading these is relocation's job
            replica, count = self.preload
            for _ in range(count):
                self.driver.admit(int(self.rng.integers(*self.prompt_range)),
                                  int(self.rng.integers(
                                      *self.preload_max_new)),
                                  place=replica)
        self.failed: set[int] = set()
        self.round_times: list[float] = []   # slowest live replica, measured
        self.round_tokens: list[int] = []
        self.tokens = 0
        self.iter = 0

    def run(self, rounds: int) -> "RealDecodeSim":
        d = self.driver
        for _ in range(rounds):
            if self.iter in self.fail_at:
                self.failed.add(self.fail_at[self.iter])
            for _ in range(self.rng.poisson(self.arrival_rate)):
                d.admit(int(self.rng.integers(*self.prompt_range)),
                        int(self.rng.integers(*self.max_new_range)))
            w = self.work if self.iter >= self.work_from else None
            info = d.decode_round(failed=self.failed, work=w)
            t = info["decode_s"]
            finite = t[np.isfinite(t)]
            self.round_times.append(float(finite.max()) if len(finite) else 0.0)
            self.round_tokens.append(info["decoded"])
            self.tokens += info["decoded"]
            self.iter += 1
        d.sync()
        return self

    def throughput(self, *, trim: float = 0.1, skip: int = 0,
                   until: int | None = None) -> float:
        """Tokens per second of simulated-concurrent serving: replicas
        decode in parallel, so a round costs its slowest measured time.
        The ``trim`` fraction of slowest rounds is dropped with their
        tokens; ``skip``/``until`` bound the measured window."""
        times = np.asarray(self.round_times[skip:until])
        toks = np.asarray(self.round_tokens[skip:until], np.float64)
        if len(times) == 0:
            return 0.0
        keep = len(times) - int(trim * len(times))
        order = np.argsort(times)[:max(keep, 1)]
        wall = float(times[order].sum())
        return float(toks[order].sum()) / wall if wall > 0 else 0.0

    def window_p95(self) -> list[float]:
        from .elastic import window_p95
        return window_p95(self.round_times, self.glb_period)
