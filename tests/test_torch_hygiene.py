"""Port hygiene: the package and chip_smoke.py import no JAX, and none of
the packages the card's machine lacks (transformers, regex, ftfy,
torchvision, timm, safetensors, segment_anything, clip), not even lazily;
the package imports with neither triton nor nvcc; the entry points and the
2D providers refuse to run without CUDA unless the CPU was asked for; a
failed kernel build raises."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "semantic_gaussians_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "semantic_gaussians_tpu",
             # the repo's root tools: the port keeps its own copies
             "tools",
             # absent where the port runs
             "transformers", "regex", "ftfy", "torchvision", "timm", "safetensors",
             "segment_anything", "clip")


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_package_imports_without_triton_or_nvcc(tmp_path):
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys; sys.modules['triton'] = None\n"  # any `import triton` fails
        "import importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path), PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from semantic_gaussians_torch.cli import view_server
    from semantic_gaussians_torch.config.config import DotDict
    from semantic_gaussians_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = DotDict.wrap({"model": {"model_dir": str(tmp_path)}, "render": {}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        view_server.ViewerState(cfg)
    yaml = tmp_path / "v.yaml"
    yaml.write_text(f"model:\n  model_dir: {tmp_path}\nrender:\n  port: 0\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        view_server.main([str(yaml)])


def test_train_cli_raises_without_cuda(monkeypatch, tmp_path):
    """The train CLI refuses to start without CUDA unless the CPU was asked
    for; asked for, it gets as far as the (missing) scene."""
    from semantic_gaussians_torch.cli import train
    from semantic_gaussians_torch.config.config import default_config_dir

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [str(default_config_dir() / "official_train.yaml"), f"scene.scene_path={tmp_path}",
            f"train.out_dir={tmp_path / 'out'}"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(args)
    for cpu in (["--device", "cpu"], ["train.device=cpu"]):
        with pytest.raises(ValueError, match="Could not recognize scene type"):
            train.main(args + cpu)


def test_distributed_train_cli_raises_without_cuda(monkeypatch, tmp_path):
    """With pipeline.distributed=true the train CLI still refuses to start
    without CUDA unless the CPU was asked for (then it runs its ranks on
    gloo; unlaunched, as one rank) and gets as far as the (missing) scene;
    a launched rank resolves its device before making the process group."""
    from semantic_gaussians_torch.cli import train
    from semantic_gaussians_torch.config.config import default_config_dir

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("SGTPU_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    args = [str(default_config_dir() / "official_train.yaml"), f"scene.scene_path={tmp_path}",
            f"train.out_dir={tmp_path / 'out'}", "pipeline.distributed=true"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(args)
    with pytest.raises(ValueError, match="Could not recognize scene type"):
        train.main(args + ["--device", "cpu"])
    monkeypatch.setenv("SGTPU_COORDINATOR", f"file://{tmp_path / 'store'}")
    monkeypatch.setenv("SGTPU_NUM_PROCS", "2")
    monkeypatch.setenv("SGTPU_PROC_ID", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(args)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cli,yaml,section", [
    ("fusion", "fusion_scannet.yaml", "fusion"),
    ("eval_segmentation", "eval.yaml", "eval"),
])
def test_fusion_and_eval_clis_raise_without_cuda(monkeypatch, tmp_path, cli, yaml, section):
    """The fusion and eval CLIs refuse to start without CUDA unless the CPU
    was asked for; asked for, they get as far as the (missing) scene."""
    import importlib

    from semantic_gaussians_torch.config.config import default_config_dir

    main = importlib.import_module(f"semantic_gaussians_torch.cli.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [str(default_config_dir() / yaml), f"scene.scene_path={tmp_path}",
            f"model.model_dir={tmp_path}", f"fusion.out_dir={tmp_path / 'out'}"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
    for cpu in (["--device", "cpu"], [f"{section}.device=cpu"]):
        with pytest.raises(ValueError, match="Could not recognize scene type"):
            main(args + cpu)


def test_distill_cli_raises_without_cuda(monkeypatch, tmp_path):
    """The distill CLI refuses to start without CUDA unless the CPU was
    asked for; asked for, it gets as far as the (missing) scenes."""
    from semantic_gaussians_torch.cli import distill
    from semantic_gaussians_torch.config.config import default_config_dir

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [str(default_config_dir() / "distill_scannet.yaml"), f"model.model_dir={tmp_path}",
            f"fusion.out_dir={tmp_path / 'out'}", f"distill.out_dir={tmp_path / 'distill'}"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distill.main(args)
    for cpu in (["--device", "cpu"], ["distill.device=cpu"]):
        with pytest.raises(FileNotFoundError, match="no \\(point_cloud.ply, fused .pt\\) pairs"):
            distill.main(args + cpu)


@pytest.mark.parametrize("entry", ["make_distill_state", "train_distill",
                                   "make_eval_render_hook"])
def test_distill_pipeline_defaults_to_cuda(monkeypatch, tmp_path, entry):
    """The distill pipeline's functions that make a model or a scene's
    tensors run on CUDA unless the caller passes a device: without CUDA
    they raise before any work."""
    from semantic_gaussians_torch.pipelines import distill as td

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = td.DistillConfig(model_3d="MinkUNet14A", feature_dim=4)
    call = {
        "make_distill_state": lambda: td.make_distill_state(cfg, 1),
        "train_distill": lambda: td.train_distill([], cfg),
        "make_eval_render_hook": lambda: td.make_eval_render_hook(
            tmp_path / "none.ply", [], np.zeros((2, 4), np.float32), tmp_path, cfg),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("provider", ["CLIPTextEncoder", "CLIPImageEncoder", "SAMCLIPPredictor",
                                      "VLPartPredictor", "LSegPredictor", "TorchCLIPTextEncoder",
                                      "make_predictor"])
def test_2d_providers_raise_without_cuda(monkeypatch, tmp_path, provider):
    """Each 2D tower's entry point resolves its device before it reads a
    file: without CUDA, and without device="cpu", it raises."""
    from semantic_gaussians_torch.models import (
        clip_text, clip_vision, lseg, predictors, samclip, vlpart,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = str(tmp_path / "none.pt")
    call = {
        "CLIPTextEncoder": lambda: clip_text.CLIPTextEncoder(ckpt),
        "CLIPImageEncoder": lambda: clip_vision.CLIPImageEncoder(checkpoint_path=ckpt),
        "SAMCLIPPredictor": lambda: samclip.SAMCLIPPredictor(None, None),
        "VLPartPredictor": lambda: vlpart.VLPartPredictor(None, None),
        "LSegPredictor": lambda: lseg.LSegPredictor(ckpt),
        "TorchCLIPTextEncoder": lambda: predictors.TorchCLIPTextEncoder(tmp_path),
        "make_predictor": lambda: predictors.make_predictor(
            "samclip", {"sam_checkpoint": ckpt, "clip_checkpoint": ckpt}),
    }[provider]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


@pytest.mark.parametrize("tool", ["exp_panel", "exp_panel2"])
def test_probe_tools_raise_without_cuda(monkeypatch, tool):
    import importlib

    main = importlib.import_module(f"semantic_gaussians_torch.tools.{tool}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--scale", "0.001"])
    assert main(["--device", "cpu", "--scale", "0.001"])


def test_wrappers_reject_other_devices():
    from semantic_gaussians_torch.ops.composite import composite_backward, composite_forward
    from semantic_gaussians_torch.ops.expand import expand_pairs
    from semantic_gaussians_torch.ops.segsum import segsum_contiguous

    m = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        expand_pairs(m, m, m, None, m[0], m[0], 512, 1, 1, 4)
    g = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        composite_forward(g, g, m, m, m, g[0], 1, 16, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        composite_backward(g, g, m, m, m, g[0], g, g, m, 1, 16, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        segsum_contiguous(g, m, 4)
    from semantic_gaussians_torch.ops.segsum_probe import segsum_probe

    for mode in ("fold", "window"):
        with pytest.raises(ValueError, match="unsupported device"):
            segsum_probe(torch.zeros((512, 16), device="meta"),
                         torch.zeros(512, dtype=torch.int32, device="meta"), mode)


def test_failed_build_raises(monkeypatch, tmp_path):
    from semantic_gaussians_torch.ops import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_all()
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    with pytest.raises(RuntimeError, match="nvcc failed for expand.cu"):
        kernels.build_all(["expand"])
    with pytest.raises(RuntimeError, match="nvcc failed for composite_bwd.cu"):
        kernels.build_all()
    with pytest.raises(RuntimeError, match="nvcc failed for segsum_probe.cu"):
        kernels.build_all(["segsum_probe"])
    assert set(kernels.SOURCES) == {"expand", "composite_fwd", "composite_bwd", "segsum",
                                    "segsum_probe", "phase", "projection", "adam"}
    assert all((kernels.CSRC / f"{name}.cu").is_file() for name in kernels.SOURCES)
    # the bit-compared alpha and cull decisions build without FMA contraction
    assert "-fmad=false" in kernels.NVCC_FLAGS


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
