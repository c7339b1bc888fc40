"""Import hygiene of the PyTorch port.

``paddle_tpu_torch``, ``chip_smoke.py`` and the card probes under
``probes/`` must never import ``jax``, ``jaxlib``, ``orbax`` or any part
of ``paddle_tpu`` (importing any ``paddle_tpu.*`` runs
``paddle_tpu/__init__.py``, which imports JAX). Names are matched
exactly: ``paddle_tpu_torch`` itself starts with ``paddle_tpu``.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "orbax", "paddle_tpu")

_PROBE = r"""
import importlib, json, pkgutil, sys
{imports}
bad = sorted(n for n in sys.modules
             if n in {forbidden!r} or n.startswith(tuple(f + "." for f in {forbidden!r})))
print(json.dumps({{"bad": bad, "port": sorted(n for n in sys.modules
                                              if n.startswith("paddle_tpu_torch"))}}))
"""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""      # never reach a card from a test
    return env


def _probe(imports: str):
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(imports=imports,
                                             forbidden=FORBIDDEN)],
        cwd=REPO, env=_clean_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _imported_names(path: Path):
    """Every module an ``import`` statement of the file names, at any
    depth (lazy imports inside functions included)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_package_imports_no_jax_or_paddle_tpu():
    res = _probe(
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "
        "'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)")
    assert res["bad"] == []
    for mod in ("paddle_tpu_torch.generation.engine",
                "paddle_tpu_torch.inference.predictor",
                "paddle_tpu_torch.kernels.ragged_paged_attention",
                "paddle_tpu_torch.kernels._build",
                # the training slice's subpackages and modules
                "paddle_tpu_torch.core.framework",
                "paddle_tpu_torch.core.registry",
                "paddle_tpu_torch.core.backward",
                "paddle_tpu_torch.core.executor",
                "paddle_tpu_torch.layers.nn",
                "paddle_tpu_torch.ops.nn",
                "paddle_tpu_torch.ops.optim",
                "paddle_tpu_torch.optimizer",
                "paddle_tpu_torch.kernels.softmax_xent",
                "paddle_tpu_torch.kernels.fused_optim",
                # the flash-attention / BERT / AMP slice
                "paddle_tpu_torch.kernels.flash_attention",
                "paddle_tpu_torch.models.bert",
                "paddle_tpu_torch.contrib.mixed_precision.decorator",
                "paddle_tpu_torch.ops.control",
                # the quantized, multi-adapter serving slice
                "paddle_tpu_torch.quantize",
                "paddle_tpu_torch.adapters.store",
                "paddle_tpu_torch.adapters.rewrite",
                "paddle_tpu_torch.kernels.quant_matmul",
                "paddle_tpu_torch.kernels.lora",
                "paddle_tpu_torch.kernels.quant",
                # Momentum / ResNet-50 and the two_lane engine
                "paddle_tpu_torch.clip",
                "paddle_tpu_torch.regularizer",
                "paddle_tpu_torch.models.resnet",
                "paddle_tpu_torch.ops.metrics",
                "paddle_tpu_torch.layers.metric_op",
                "paddle_tpu_torch.kernels.paged_attention",
                # saving and serving Programs over HTTP
                "paddle_tpu_torch.io",
                "paddle_tpu_torch.ops.quant",
                "paddle_tpu_torch.runtime.dispatch",
                "paddle_tpu_torch.serving.engine",
                "paddle_tpu_torch.serving.metrics",
                "paddle_tpu_torch.serving.server",
                # checkpoints, supervised training, the other optimizers
                # and the learning-rate schedules
                "paddle_tpu_torch.fs",
                "paddle_tpu_torch.observability.flight",
                "paddle_tpu_torch.observability.tracing",
                "paddle_tpu_torch.resilience.faults",
                "paddle_tpu_torch.resilience.checkpoint",
                "paddle_tpu_torch.resilience.supervisor",
                "paddle_tpu_torch.layers.control_flow",
                "paddle_tpu_torch.layers.learning_rate_scheduler",
                # the rest of the training path: SelectedRows, control
                # flow and recompute, MoE, the CTR models
                "paddle_tpu_torch.core.selected_rows",
                "paddle_tpu_torch.core.control_flow",
                "paddle_tpu_torch.ops.lod",
                "paddle_tpu_torch.ops.moe",
                "paddle_tpu_torch.layers.extras",
                "paddle_tpu_torch.models.ctr",
                # the fake-quantize family, QAT and the everyday layers
                "paddle_tpu_torch.ops.misc",
                "paddle_tpu_torch.layers.ops",
                "paddle_tpu_torch.layers.tensor",
                "paddle_tpu_torch.nets",
                "paddle_tpu_torch.models.mnist",
                "paddle_tpu_torch.models.vision",
                "paddle_tpu_torch.contrib.slim",
                "paddle_tpu_torch.contrib.slim.quantization",
                # the serving host tiers
                "paddle_tpu_torch.observability.registry",
                "paddle_tpu_torch.observability.propagate",
                "paddle_tpu_torch.observability.fleet",
                "paddle_tpu_torch.traffic.admission",
                "paddle_tpu_torch.traffic.controller",
                "paddle_tpu_torch.traffic.frontend",
                "paddle_tpu_torch.traffic.metrics",
                "paddle_tpu_torch.disagg.pagestore",
                "paddle_tpu_torch.disagg.roles",
                # the data tiers
                "paddle_tpu_torch.reader",
                "paddle_tpu_torch.data_feeder",
                "paddle_tpu_torch.lod_tensor",
                "paddle_tpu_torch.dataset",
                "paddle_tpu_torch.dataset_runner",
                "paddle_tpu_torch.native.datafeed",
                "paddle_tpu_torch.datasets.flowers",
                "paddle_tpu_torch.profiler",
                "paddle_tpu_torch.tools_timeline",
                "paddle_tpu_torch.metrics",
                "paddle_tpu_torch.average",
                "paddle_tpu_torch.runtime.prefetch"):
        assert mod in res["port"]


def test_chip_smoke_imports_no_jax_or_paddle_tpu():
    names = sorted(set(_imported_names(REPO / "chip_smoke.py")))
    assert any(n.startswith("paddle_tpu_torch") for n in names)
    res = _probe("import chip_smoke\n" + "\n".join(
        f"importlib.import_module({n!r})" for n in names))
    assert res["bad"] == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
    + sorted(str(p.relative_to(REPO)) for p in (REPO / "probes").glob("*.py")))
def test_no_import_statement_names_jax_or_paddle_tpu(path):
    bad = [n for n in _imported_names(REPO / path) if _forbidden(n)]
    assert bad == [], f"{path} imports {bad}"


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                          cwd=cwd, env=_clean_env(), capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "torch.cuda.is_available() is false" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
