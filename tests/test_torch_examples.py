"""PyTorch port: the example twins run end to end on the CPU, each once in
a subprocess at its smallest arguments: ``examples/serve_lm_torch.py``
(monolithic, chunked, paged and prefix-cached serving token-identical,
int8 pools under 0.55x the fp bytes) and ``examples/train_lm_torch.py``
(3 steps of the ~20M model on 2 x 64 tokens, the loss below its start)."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                        "--device", "cpu", *args], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_serve_lm_torch():
    out = run("serve_lm_torch.py")
    assert ("monolithic == chunked == chunked+paged == prefix-cached "
            "(cold & warm), token for token") in out
    assert "int8 KV cache:" in out


def test_train_lm_torch(tmp_path):
    out = run("train_lm_torch.py", "--steps", "3", "--batch", "2", "--seq",
              "64", "--ckpt-dir", str(tmp_path))
    assert "model: lm20m" in out and "final loss:" in out
