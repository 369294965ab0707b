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

``--mesh_data D --mesh_model M`` trains over a D × M mesh of rank threads
on the device (``parallel/sharding.py``: the env batch and minibatches
split over data, the linear layers sharded over model, a step of all ranks
one CUDA graph on the card). ``--multihost`` starts ``torch.distributed``
from ``JAX_COORDINATOR``/``NPROC``/``PROC_ID`` (``parallel/distributed.py``)
and runs the data axis as those processes, eagerly (gloo through host
memory when the processes share a card); only process 0 writes the output
directory. ``--profile_dir`` writes a ``torch.profiler`` Chrome trace of
the run (``utils/profiling.py``). ``--platform`` is ``--device`` here.

    python -m relationalgraphlearning_tpu_torch.cli.train --debug \\
        --mesh_data 2 --mesh_model 2 --output_dir data/mesh
    JAX_COORDINATOR=localhost:8476 NPROC=2 PROC_ID=$i \\
        python -m relationalgraphlearning_tpu_torch.cli.train --debug \\
        --multihost --output_dir data/procs        # i = 0, 1
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
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--multihost", action="store_true",
                   help="initialize torch.distributed from JAX_COORDINATOR/"
                        "NPROC/PROC_ID; the processes are the data axis")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-parallel mesh axis size (0 = no mesh; env "
                        "batch + minibatches split, gradients summed)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel mesh axis size")
    args = p.parse_args(argv)

    comm = None
    if args.multihost:
        from relationalgraphlearning_tpu_torch.parallel import distributed
        from relationalgraphlearning_tpu_torch.parallel.comm import DistComm

        if args.mesh_model != 1:
            p.error("--multihost runs the data axis as processes; "
                    "--mesh_model must be 1")
        if distributed.initialize():
            comm = DistComm()
            if args.mesh_data not in (0, comm.size):
                p.error(f"--mesh_data {args.mesh_data} with {comm.size} "
                        "processes")
    lead = comm is None or comm.rank == 0

    if lead and os.path.exists(args.output_dir) and not (
            args.resume or args.overwrite):
        p.error(f"{args.output_dir} exists; pass --overwrite to clear it "
                "or --resume to continue from its checkpoints")
    if comm is not None:
        comm.barrier()  # the first process has looked before any writes
    if lead and args.overwrite and not args.resume and os.path.exists(
            args.output_dir):
        shutil.rmtree(args.output_dir)
    os.makedirs(args.output_dir, exist_ok=True)

    # file + stdout logging in the reference's format (the first process
    # alone writes the file)
    handlers: list = [logging.StreamHandler(sys.stdout)]
    if lead:
        handlers.append(logging.FileHandler(
            os.path.join(args.output_dir, "output.log"), mode="a"))
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
    from relationalgraphlearning_tpu_torch.parallel.mesh import make_mesh
    from relationalgraphlearning_tpu_torch.training.train_loop import (
        LoopOptions, train)
    from relationalgraphlearning_tpu_torch.utils import profiling

    try:
        if args.config:
            config = load_config_module(args.config)
            if lead:
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
        mesh = None
        if args.mesh_data and comm is None:
            mesh = make_mesh(data=args.mesh_data, model=args.mesh_model,
                             device=args.device)
        with profiling.trace(args.profile_dir):
            result = train(
                config, args.policy, args.output_dir, debug=args.debug,
                resume=args.resume, seed=args.randomseed,
                opts=LoopOptions(train_envs=args.train_envs,
                                 collect_steps=args.collect_steps,
                                 mesh=mesh, comm=comm),
                device=args.device)
        logging.info("done: %s", result)
    finally:
        for h in handlers:
            root.removeHandler(h)
            h.close()
    return result


if __name__ == "__main__":
    main()
