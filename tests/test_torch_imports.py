"""The port stands alone: no file of ``src/repro_torch`` and no line of
``chip_smoke.py`` imports JAX, the JAX package ``repro`` or ``xxhash`` (the
shard store's digests are the standard library's CRC32)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "xxhash")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", "")) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_covers_its_layout():
    rel = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    for name in ("core/kernel_fn.py", "core/nystrom.py", "core/dual_solver.py",
                 "core/ovo.py", "core/svm.py", "core/quant.py", "core/streaming.py",
                 "core/solver_stream.py", "core/polish.py", "core/cv.py",
                 "core/compact.py", "core/trace.py", "core/block_cache.py",
                 "core/faults.py", "core/resilience.py", "core/shards.py",
                 "core/distributed.py",
                 "kernels/build.py", "kernels/gram.py",
                 "kernels/smo.py", "kernels/ops.py", "data/synthetic.py",
                 "convert.py", "kernels/flash_attention.py", "configs/base.py",
                 "configs/qwen3_0_6b.py", "configs/tinyllama_1_1b.py",
                 "configs/codeqwen1_5_7b.py", "configs/minitron_4b.py",
                 "launch/steps.py", "launch/serve.py",
                 "models/common.py", "models/attention.py", "models/blocks.py",
                 "models/model.py", "launch/train_svm.py",
                 "data/libsvm_format.py", "checkpoint/ckpt.py"):
        assert name in rel
    for cu in ("gram.cu", "gram_q8.cu", "smo.cu", "flash_attention.cu"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / cu).is_file()


def test_import_leaves_no_jax_in_sys_modules():
    code = ("import sys, repro_torch, repro_torch.convert, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.core.trace, "
            "repro_torch.core.block_cache, repro_torch.core.faults, "
            "repro_torch.core.resilience, repro_torch.core.shards, "
            "repro_torch.core.distributed, repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'xxhash')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
