"""Guards of the port's package boundary.

The port imports ``torch``, ``numpy`` and the standard library only:
never ``jax``, ``ml_dtypes`` or anything of the JAX package ``repro``
(not even its pure-Python modules), and neither does ``chip_smoke.py``.
Its entry points run on the card unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    files = sorted(PORT.rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_package_has_the_slice_modules():
    for mod in ("core/distribution.py", "core/telemetry.py",
                "core/collections.py", "core/transport.py",
                "core/relocation.py", "core/teamed.py", "core/balancer.py",
                "core/glb.py", "core/spmd_glb.py", "core/interop.py",
                "kernels/ops.py", "kernels/ref.py", "kernels/reloc_codec.py",
                "kernels/csrc/reloc_codec.cu", "analysis/sanitizer.py",
                "kernels/cuda_build.py", "kernels/flash_attention.py",
                "kernels/csrc/flash_attention.cu", "models/config.py",
                "models/parallel.py", "models/layers.py",
                "models/attention.py", "models/transformer.py",
                "models/zoo.py", "configs/__init__.py",
                "configs/qwen2_1_5b.py", "serving/cache.py",
                "serving/workload.py", "serving/router.py",
                "serving/elastic.py", "serving/decode.py",
                "runtime/fault_tolerance.py"):
        assert (PORT / mod).is_file(), mod


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, repro_torch.core, repro_torch.kernels.ops, "
            "repro_torch.core.interop, repro_torch.models, "
            "repro_torch.configs, repro_torch.serving, "
            "repro_torch.runtime\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_place_group_defaults_to_the_card():
    from repro_torch.core import PlaceGroup

    if torch.cuda.is_available():
        assert PlaceGroup(4).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlaceGroup(4)
    g = PlaceGroup(4, device="cpu")
    assert g.device.type == "cpu" and g.subgroup((1, 2)).device == g.device


def test_kernel_build_needs_no_card_to_import():
    # importing the kernel modules builds nothing; the build happens at
    # the first launch on a CUDA tensor
    from repro_torch.kernels import cuda_build, flash_attention, reloc_codec

    for mod in (reloc_codec, flash_attention):
        assert mod.LIBRARY._lib is None or torch.cuda.is_available()
    # one registry counts every kernel of the port
    assert reloc_codec.launch_counts is cuda_build.launch_counts
    assert set(cuda_build.launch_counts) == set(reloc_codec.KERNELS) | set(
        flash_attention.KERNELS)
    assert flash_attention.SOURCE == \
        "src/repro_torch/kernels/csrc/flash_attention.cu"


def test_serving_entry_points_default_to_the_card():
    from repro_torch.models import zoo
    from repro_torch.serving import (DecodeEngine, ElasticServingDriver,
                                     serving_config)

    if torch.cuda.is_available():
        assert zoo.default_device().type == "cuda"
        return
    for make in (DecodeEngine, lambda: ElasticServingDriver(2),
                 lambda: zoo.init_params(serving_config(), 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    d = ElasticServingDriver(2, device="cpu")
    assert d.group.device.type == "cpu"
