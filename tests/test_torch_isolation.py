"""The port stands alone: no JAX, no ``repro`` (not even its numpy-only
modules), in ``src/repro_torch`` and in ``chip_smoke.py``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_repro():
    mods = list(_port_modules())
    for m in ("repro_torch.api.session", "repro_torch.api.registry",
              "repro_torch.core.properties", "repro_torch.core.pagerank",
              "repro_torch.core.blocked", "repro_torch.core.fault_domain",
              "repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
              "repro_torch.kernels.nvcc",
              "repro_torch.kernels.blocked_sweep.blocked_sweep",
              "repro_torch.core.distributed", "repro_torch.graphs.partition",
              "repro_torch.dist.compression", "repro_torch.models.gnn",
              "repro_torch.models.gnn.common", "repro_torch.configs",
              "repro_torch.configs.registry", "repro_torch.graphs.sampler",
              "repro_torch.data.pipeline",
              "repro_torch.models.transformer",
              "repro_torch.models.transformer.config",
              "repro_torch.models.transformer.layers",
              "repro_torch.models.transformer.model",
              "repro_torch.configs.qwen1_5_4b",
              "repro_torch.configs.phi4_mini_3_8b",
              "repro_torch.configs.nemotron_4_340b",
              "repro_torch.configs.granite_moe_3b_a800m",
              "repro_torch.configs.mixtral_8x22b"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "", out.stdout


def test_no_file_of_the_port_names_jax_or_repro_in_an_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{f.relative_to(ROOT)}: {name}")
    assert not offenders, offenders
