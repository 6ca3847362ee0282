"""Parallelism context threaded through model code.

The port of ``repro.models.parallel`` for one card: a :class:`Parallel`
with ``mesh=None`` (no mesh axes to shard over), and :func:`constrain`
as the identity.  Mesh sharding waits for the distributed slice; a
non-None mesh raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

__all__ = ["Parallel", "constrain"]


@dataclass(frozen=True)
class Parallel:
    mesh: Optional[Any] = None
    batch_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp: bool = False
    seq_shard_decode: bool = False
    pipeline_axis: Optional[str] = None
    attn_constrain: bool = False

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the port runs on one card: mesh sharding waits for the "
                "distributed slice (ROADMAP.md queue 1)")


def constrain(par: Parallel, x, spec=None):
    """Sharding constraint: the identity on one card."""
    return x
