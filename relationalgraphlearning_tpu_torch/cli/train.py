"""Training CLI of the PyTorch port (port of
``relationalgraphlearning_tpu/cli/train.py``).

Loads a config module by path (``get_config() -> Config``; the JAX
package's config files load as they are), copies it into ``--output_dir``
as ``config.py``, logs to ``output.log`` and stdout in the reference's
format, and runs imitation + RL (``training/train_loop.py``) on the card
(``--device cpu`` on the CPU). An existing ``--output_dir`` is refused
unless ``--overwrite`` (cleared first) or ``--resume`` is given; nothing
prompts, so an unattended run cannot hang.

    python -m relationalgraphlearning_tpu_torch.cli.train \\
        --config configs/icra_benchmark/mp_separate.py --randomseed 0 \\
        --output_dir data/mp_separate_s0

Not ported yet: ``--platform`` (replaced by ``--device``), the multi-device
flags ``--mesh_data``/``--mesh_model``/``--multihost`` (ROADMAP Queue A 11)
and ``--profile_dir`` (Queue A 12).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import shutil
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="Train a crowd navigation "
                                "policy with the PyTorch port")
    p.add_argument("--policy", default="model_predictive_rl")
    p.add_argument("--config", default=None,
                   help="python config file exposing get_config() -> Config")
    p.add_argument("--output_dir", default="data/output")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--randomseed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless asked (cpu)")
    p.add_argument("--train_envs", type=int, default=16)
    p.add_argument("--collect_steps", type=int, default=64)
    p.add_argument("--rl_train_episodes", type=int, default=None,
                   help="override config.train.rl_train_episodes")
    p.add_argument("--evaluation_interval", type=int, default=None,
                   help="override config.train.evaluation_interval")
    p.add_argument("--target_update_interval", type=int, default=None)
    p.add_argument("--rl_learning_rate", type=float, default=None)
    p.add_argument("--val_size", type=int, default=None,
                   help="override config.env.sim.val_size")
    args = p.parse_args(argv)

    if os.path.exists(args.output_dir) and not (args.resume
                                                or args.overwrite):
        p.error(f"{args.output_dir} exists; pass --overwrite to clear it "
                "or --resume to continue from its checkpoints")
    if args.overwrite and not args.resume and os.path.exists(
            args.output_dir):
        shutil.rmtree(args.output_dir)
    os.makedirs(args.output_dir, exist_ok=True)

    # file + stdout logging in the reference's format
    log_file = os.path.join(args.output_dir, "output.log")
    handlers = [logging.FileHandler(log_file, mode="a"),
                logging.StreamHandler(sys.stdout)]
    root = logging.getLogger()
    root.setLevel(logging.DEBUG if args.debug else logging.INFO)
    fmt = logging.Formatter("%(asctime)s, %(levelname)s: %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)
    for noisy in ("matplotlib", "PIL", "tensorboard", "h5py"):
        logging.getLogger(noisy).setLevel(logging.WARNING)

    from relationalgraphlearning_tpu_torch.configs.base import (
        Config, load_config_module)
    from relationalgraphlearning_tpu_torch.training.train_loop import (
        LoopOptions, train)

    try:
        if args.config:
            config = load_config_module(args.config)
            shutil.copy(args.config,
                        os.path.join(args.output_dir, "config.py"))
        else:
            config = Config()
        tc_over = {k: v for k, v in (
            ("rl_train_episodes", args.rl_train_episodes),
            ("evaluation_interval", args.evaluation_interval),
            ("target_update_interval", args.target_update_interval),
            ("rl_learning_rate", args.rl_learning_rate)) if v is not None}
        if tc_over:
            config = dataclasses.replace(
                config, train=dataclasses.replace(config.train, **tc_over))
        if args.val_size is not None:
            config = dataclasses.replace(
                config, env=dataclasses.replace(
                    config.env, sim=dataclasses.replace(
                        config.env.sim, val_size=args.val_size)))
        logging.info("policy: %s | config: %s | seed: %d | device: %s",
                     args.policy, args.config or "<default>",
                     args.randomseed, args.device)
        result = train(
            config, args.policy, args.output_dir, debug=args.debug,
            resume=args.resume, seed=args.randomseed,
            opts=LoopOptions(train_envs=args.train_envs,
                             collect_steps=args.collect_steps),
            device=args.device)
        logging.info("done: %s", result)
    finally:
        for h in handlers:
            root.removeHandler(h)
            h.close()
    return result


if __name__ == "__main__":
    main()
