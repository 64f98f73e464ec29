"""End-to-end example on the PyTorch port: train GraphSAGE (reduced widths,
the full_graph_sm cell's graph) with checkpoints, then crash and resume
from the last checkpoint.

    PYTHONPATH=src python examples/torch_train_graphsage.py [steps]
    PYTHONPATH=src python examples/torch_train_graphsage.py 30 --device cpu

The first runs on cuda:0 (and fails without a GPU); ``--device cpu`` runs
on the host.
"""
import argparse
import shutil
import tempfile

from repro_torch.train import TrainLoop

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("steps", nargs="?", type=int, default=200)
ap.add_argument("--device", default=None,
                help="torch device of the train steps (default cuda:0)")
args = ap.parse_args()

ckpt = tempfile.mkdtemp(prefix="sage_ckpt_")
try:
    loop = TrainLoop("graphsage-reddit", shape="full_graph_sm", reduced=True,
                     checkpoint_dir=ckpt, checkpoint_every=50, log_every=25,
                     device=args.device)
    out = loop.run(args.steps, resume=False)
    print(f"trained {args.steps} steps on {loop.device}: loss "
          f"{out['losses'][0]:.3f} -> {out['final_loss']:.3f} at "
          f"{out['steps_per_s']:.1f} steps/s")

    # crash/resume: a second loop picks up from the checkpoint
    loop2 = TrainLoop("graphsage-reddit", shape="full_graph_sm", reduced=True,
                      checkpoint_dir=ckpt, log_every=0, device=args.device)
    out2 = loop2.run(20)
    print(f"resumed +20 steps: final loss {out2['final_loss']:.3f}")
finally:
    shutil.rmtree(ckpt, ignore_errors=True)
