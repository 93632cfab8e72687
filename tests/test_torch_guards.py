"""The port stands alone and never runs on the CPU unless asked to.

* No module of ``vvc_affine_tpu_torch`` and not ``chip_smoke.py`` imports
  JAX or anything of the JAX package (an AST scan of every import).
* With no CUDA device, every entry point called without ``device="cpu"``
  raises instead of carrying on on the CPU.
* The default CUDA device carries its index, so it equals the device of
  the tensors made on it.
* Without ``nvcc`` the kernel build raises; nothing falls back.
* ``kernels.source_dir`` builds another version of the sources, and only
  inside its context.
"""

import ast
import os

import pytest
import torch

from vvc_affine_tpu_torch import cli, kernels, resolve_device
from vvc_affine_tpu_torch.models import affine_me as tme
from vvc_affine_tpu_torch.models import affine_plane as tap
from vvc_affine_tpu_torch.models import pipeline
from vvc_affine_tpu_torch.parallel import mesh as pmesh
from vvc_affine_tpu_torch.tools import (gop_golden, mosaic_probe,
                                        power_trace, profile_stage,
                                        scaling_bench, tpu_parity,
                                        xprof_trace)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    root = os.path.join(_REPO, "vvc_affine_tpu_torch")
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_port_imports_no_jax():
    """Nor the JAX repository's ``tools/`` (the port's tools keep their
    own copies of what they need from it)."""
    files = _port_files()
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "vvc_affine_tpu", "tools"), \
                f"{os.path.relpath(path, _REPO)} imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_without_a_card(no_cuda, tmp_path):
    s2 = tap.PlaneSpec("full", 2, 128, 128)
    s3 = tap.PlaneSpec("full", 3, 128, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tap.build_pair_stage(s2, s3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tap.build_stage(s2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tap.zero_cpmvs(s2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.AffineMEPipeline(pipeline.PipelineConfig(128, 128, 32))
    g2 = tme.StageSpec("full", 2, 128, 128)
    for make in (tme.build_stage, tme.build_tables, tme.zero_cpmvs):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(g2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.AffineMEPipeline(pipeline.PipelineConfig(
            128, 128, 32, engine="gather"))
    args = ["-f", "1", "-s", "128x128", "-q", "32",
            "-o", str(tmp_path / "o.csv"), "-r", str(tmp_path / "r.csv")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args + ["--DeviceIndex", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args + ["--Engine", "gather"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mosaic_probe.main([])
    # the measurement tools (energy_report reads files only: no device)
    for tool, argv in ((profile_stage, []), (xprof_trace, []),
                       (tpu_parity, []), (gop_golden, []),
                       (scaling_bench, []),
                       (power_trace, ["--", "true"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh(["cuda", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    # asking for the CPU is the one way to run there
    assert tap.zero_cpmvs(s2, "cpu").device.type == "cpu"
    assert tme.zero_cpmvs(g2, "cpu").device.type == "cpu"


def test_default_cuda_device_carries_its_index(monkeypatch):
    # tensors made on ``cuda`` report ``cuda:<n>``, and torch compares
    # devices with their index, so an entry point's default device must
    # carry one or its own input checks refuse the inputs it made
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert resolve_device() == torch.device("cuda", 2)
    assert resolve_device("cuda") == torch.device("cuda", 2)
    assert resolve_device(torch.device("cuda")).index == 2
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_kernel_source_dir_builds_the_other_sources(monkeypatch, tmp_path):
    """Inside ``source_dir`` the build reads the other directory's source:
    its library is keyed by that source (and, once built, not rebuilt:
    nvcc is not even looked for); after the context the package's own
    sources are read again."""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "build_log", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    other = tmp_path / "other"
    other.mkdir()
    (other / "warp.cu").write_text("// another version of K1\n")
    ours = kernels._so_path("warp.cu")
    with kernels.source_dir(str(other)):
        theirs = kernels._so_path("warp.cu")
        assert theirs != ours
        os.makedirs(os.path.dirname(theirs))
        open(theirs, "wb").close()
        assert kernels.build(("warp.cu",)) == 0.0
    assert kernels._so_path("warp.cu") == ours
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build(("warp.cu",))
    assert kernels.build_log == {}
