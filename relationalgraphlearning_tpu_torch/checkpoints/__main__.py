"""Write an exported JAX ``TrainState`` as a checkpoint of the port:

    python -m relationalgraphlearning_tpu_torch.checkpoints mp_unicycle \\
        data/mp_unicycle_anneal/rl_model

``cli.train --resume`` on the directory above ``rl_model`` then continues
from it with the optimizer of its own config.
"""

import argparse
import sys

from relationalgraphlearning_tpu_torch.checkpoints import write_rl_model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model", help="the exported state <model>_state.npz")
    p.add_argument("path", help="the checkpoint directory to write")
    args = p.parse_args(argv)
    state = write_rl_model(args.model, args.path)
    step = int(state["optimizer_state"][0]["step"])
    print(f"wrote {args.path}: {state['optimizer']} state at step {step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
