"""End-to-end training driver on the PyTorch port: train a reduced model for
a few hundred steps with checkpoint/restart fault tolerance, and verify the
loss goes down.  The counterpart of ``examples/train_losscurve.py``: the same
command on ``python -m repro_torch.launch.train``.

Run:  PYTHONPATH=src python examples/torch/train_losscurve.py [--device cuda|cpu]
(``--device`` defaults to ``cuda``; full size on the card: python -m
repro_torch.launch.train --arch qwen2.5-3b --steps 500 --batch 4 --seq 512,
as chip_smoke.py phase 10c trains it.)
"""
import os
import subprocess
import sys

device = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else "cuda"
cmd = [sys.executable, "-m", "repro_torch.launch.train",
       "--arch", "qwen2.5-3b", "--smoke", "--device", device,
       "--steps", "200", "--batch", "8", "--seq", "128",
       "--ckpt-dir", "results/ckpt_example_torch", "--ckpt-every", "50",
       "--log-every", "20"]
print("launching:", " ".join(cmd))
sys.exit(subprocess.run(cmd, env={"PYTHONPATH": "src", **os.environ}).returncode)
