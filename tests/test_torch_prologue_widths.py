"""The row widths that the port's configs give K2, K3 and K7's operand pass
are the ones ``csrc/prologue.cu`` instantiates at compile time
(``MC_ROW_WIDTHS``), and no module of the port imports ``triton``.

A config with a new width fails here until the width joins the kernel's
list (the runtime-width body would run it, slower)."""

import ast
import os
import re

import pytest

from magcache_tpu_torch.models import (flux, hunyuan, latte, open_sora_plan, qwen_image,
                                       stdit3, wan)
from magcache_tpu_torch.ops.fused_prologue import MAX_ROW_WIDTH, ROPE_HEAD_DIM
from magcache_tpu_torch.pipelines.open_sora_plan import OpenSoraPlanPipelineConfig
from magcache_tpu_torch.pipelines.wan import MODEL_TASKS, WanPipelineConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "magcache_tpu_torch")

# the config classes whose blocks run K2 (rms_norm_rope), K3 (layer_norm_mod)
# or K7 (lnmod_matmul), with the attribute holding the row width and whether
# they run K2
FAMILIES = ((wan.WanConfig, "dim", True), (flux.FluxConfig, "hidden", True),
            (hunyuan.HunyuanConfig, "hidden", True),
            (qwen_image.QwenImageConfig, "hidden", True),
            (stdit3.STDiT3Config, "hidden", False), (latte.LatteConfig, "hidden", False),
            (open_sora_plan.OpenSoraPlanConfig, "hidden", False))
MODULES = (wan, flux, hunyuan, qwen_image, stdit3, latte, open_sora_plan)


def _instantiated():
    with open(os.path.join(PKG, "csrc", "prologue.cu")) as f:
        m = re.search(r"#define MC_ROW_WIDTHS\(X\)((?: X\(\d+\))+)", f.read())
    assert m, "csrc/prologue.cu lost its MC_ROW_WIDTHS list"
    return tuple(int(w) for w in re.findall(r"\d+", m.group(1)))


def _configs():
    """Every published config of those families: the modules' constants,
    the classes' defaults, and the trunks the pipelines build from a preset
    name."""
    out = {}
    for mod in MODULES:
        for name, obj in vars(mod).items():
            for cls, attr, k2 in FAMILIES:
                if isinstance(obj, cls):
                    out[f"{mod.__name__.rsplit('.', 1)[1]}.{name}"] = (obj, attr, k2)
    for cls, attr, k2 in FAMILIES:
        out[f"{cls.__name__}()"] = (cls(), attr, k2)
    for model, tasks in MODEL_TASKS.items():
        for task in tasks:
            cfg = WanPipelineConfig(model=model, task=task).model_config()
            out[f"{model} {task}"] = (cfg, "dim", True)
    for version in ("v120", "v110"):
        cfg = OpenSoraPlanPipelineConfig(version=version).model_config()
        out[f"open-sora-plan {version}"] = (cfg, "hidden", False)
    return out


CONFIGS = _configs()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_config_width_is_an_instantiated_width(name):
    cfg, attr, k2 = CONFIGS[name]
    width = getattr(cfg, attr)
    assert width % 8 == 0 and width <= MAX_ROW_WIDTH
    assert width in _instantiated(), (
        f"{name}: row width {width} is not in csrc/prologue.cu's MC_ROW_WIDTHS "
        f"{_instantiated()}; add it there")
    if k2:
        assert width == cfg.heads * ROPE_HEAD_DIM


def test_every_instantiated_width_has_a_config():
    used = {getattr(cfg, attr) for cfg, attr, _ in CONFIGS.values()}
    assert set(_instantiated()) == used
    assert all(w % 8 == 0 and w <= MAX_ROW_WIDTH for w in _instantiated())


def _instantiated_tp():
    with open(os.path.join(PKG, "csrc", "prologue.cu")) as f:
        m = re.search(r"#define MC_TP_ROW_WIDTHS\(X\)((?: X\(\d+\))+)", f.read())
    assert m, "csrc/prologue.cu lost its MC_TP_ROW_WIDTHS list"
    return tuple(int(w) for w in re.findall(r"\d+", m.group(1)))


def test_every_wan_tp_slice_width_is_an_instantiated_tp_width():
    """K2's two tp passes run on a tp rank's slice of Wan's q / k rows: at
    tp 2 and 4 every published Wan width's slice is a compile-time instance
    of both, and every instance is such a slice."""
    want = {cfg.dim // tp for name, (cfg, attr, k2) in CONFIGS.items()
            if isinstance(cfg, wan.WanConfig) for tp in (2, 4)}
    assert set(_instantiated_tp()) == want
    assert all(w % ROPE_HEAD_DIM == 0 for w in want)


def test_no_module_of_the_port_imports_triton():
    found = []
    for dirpath, _, files in os.walk(PKG):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                found += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names
                          if n.split(".")[0] == "triton"]
    assert not found, found
