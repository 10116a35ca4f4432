"""Carry a JAX run's newest training-state dump to the PyTorch port.

    python scripts/jax_dump_to_torch.py <JAX run dir> <port run dir> [--model M]

Run it where the JAX package runs (it needs JAX and orbax; the port's card
machine has neither).  It restores the newest step under
``<JAX run dir>/checkpoints`` through the JAX ``CheckpointManager`` with no
template, carries it with ``sid_lsg_torch.runtime.checkpoint.state_from_jax``
(G, psi, the EMA, both Adam states, step, nimg and, with the pixel judge, its
spectral ``u`` vectors) and writes ``<port run dir>/checkpoints/<step>/
state.pt`` through the port's ``CheckpointManager``.  The port then continues
the run with ``sid_train --resume <port run dir>`` (the same ``--sd_model``
and training flags as the JAX run).  The step generator and the data
iterators start from their seeds: the two packages draw differently, and the
dump says so.

The UNet architecture comes from ``--model`` or, without it, from the JAX
run's ``training_options.json`` (a preset, ``random:<preset>`` or an
HF-layout checkpoint directory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def unet_config(model: str):
    """The port's UNet config of a ``model`` string as ``sid_train`` takes it."""
    from sid_lsg_torch.models.configs import PRESETS, config_from_hf_json, resolve

    if model.startswith("random:"):
        model = model[len("random:"):]
    if model in PRESETS or not os.path.isdir(model):
        return resolve(model).unet
    return config_from_hf_json(model).unet


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("jax_run_dir")
    ap.add_argument("port_run_dir")
    ap.add_argument("--model", default=None,
                    help="preset or checkpoint dir of the run (default: the JAX run's "
                         "training_options.json)")
    args = ap.parse_args(argv)

    model = args.model
    if model is None:
        with open(os.path.join(args.jax_run_dir, "training_options.json")) as f:
            model = json.load(f)["model"]

    import jax
    import numpy as np

    from sid_lsg_torch.runtime.checkpoint import CheckpointManager, state_from_jax
    from sid_lsg_tpu.runtime.checkpoint import CheckpointManager as JaxCheckpointManager

    jmgr = JaxCheckpointManager(os.path.join(args.jax_run_dir, "checkpoints"))
    step = jmgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no orbax dump under {args.jax_run_dir}/checkpoints")
    restored = jax.tree_util.tree_map(np.asarray, jmgr.restore(step))
    jmgr.close()
    tree = state_from_jax(restored, unet_config(model))
    path = CheckpointManager(os.path.join(args.port_run_dir, "checkpoints")).save(step, tree)
    print(f"step {step} of {args.jax_run_dir} written to {path}; resume with "
          f"--resume {args.port_run_dir}.  The step generator and the data iterators start from "
          "their seeds.", flush=True)
    return path


if __name__ == "__main__":
    main()
