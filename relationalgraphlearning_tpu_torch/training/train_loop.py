"""The training pipeline: imitation from the ORCA demonstrator, then RL
fine-tuning (port of ``relationalgraphlearning_tpu/training/train_loop.py``).

Phase 1 collects ``il_episodes`` demonstrated episodes (ORCA with
``orca_safety_space``), refuses a demonstrator that succeeds in fewer than
70 % of them, runs ``il_epochs`` sweeps' worth of SGD steps over the filled
buffer and saves ``il_model``. Phase 2 runs a fresh Adam: each iteration
collects B envs × K steps with ε decayed by episodes, owes one
``train_batches`` sweep for each finished episode, updates the target net
every ``target_update_interval`` episodes, validates every
``evaluation_interval`` episodes and keeps the best on validation by
(success, return), and saves ``rl_model`` periodically and at the end.

On the card the collection step, the SGD step and the validation step each
run as a captured CUDA graph (``LoopOptions.graphed``: None captures on the
card and runs eagerly on the CPU; False is the eager loop), as the
reference runs each as one jitted program. Random draws come from two
generators seeded with ``seed``: the initial weights from a CPU one, the
minibatch indices and the exploration from one on the device.

``LoopOptions.mesh`` runs the collection and the SGD steps over a ("data",
"model") ``Mesh`` (``parallel/sharding.py``): the env batch and each
minibatch split over data, the nets' linear layers sharded over model, a
step of all ranks one CUDA graph. ``LoopOptions.comm`` (``--multihost``)
runs the data axis as ``torch.distributed`` processes instead, eagerly;
every process holds the whole buffer and state, and only the first writes
checkpoints and metrics.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import NamedTuple, Optional

import torch

from relationalgraphlearning_tpu_torch.configs.base import Config
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.parallel.mesh import Mesh
from relationalgraphlearning_tpu_torch.parallel.sharding import (
    ParallelCollect, ParallelTrainer)
from relationalgraphlearning_tpu_torch.policies.factory import make_policy
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.policies.robot_policies import (
    ORCARobotPolicy)
from relationalgraphlearning_tpu_torch.training import checkpoint as ckpt
from relationalgraphlearning_tpu_torch.training import replay_buffer as rb
from relationalgraphlearning_tpu_torch.training.explorer import (
    EvalStats, Explorer)
from relationalgraphlearning_tpu_torch.training.metrics import MetricsWriter
from relationalgraphlearning_tpu_torch.training.trainer import (
    LossAux, MPRLTrainer, VNRLTrainer)
from relationalgraphlearning_tpu_torch.utils import profiling

log = logging.getLogger(__name__)

IL_CHUNK = 2000  # imitation steps whose minibatch indices are drawn at once


@dataclasses.dataclass
class LoopOptions:
    """Batching of the loop (the reference's), and where it runs."""

    train_envs: int = 16  # parallel envs during collection
    collect_steps: int = 64  # env steps per iteration per env
    eval_envs: int = 100
    graphed: Optional[bool] = None  # None: graphs on the card, eager on CPU
    # a parallel.mesh.Mesh ("data", "model"): env batch and minibatches
    # split over data, linear layers sharded over model (sharding.py);
    # None: one device
    mesh: Optional[Mesh] = None
    # a parallel.comm.DistComm: the data axis as processes (--multihost)
    comm: Optional[object] = None


class _NoWriter:
    """A process that is not the first writes no metrics."""

    def write(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class TrainerArtifacts(NamedTuple):
    policy: object
    trainer: object
    explorer: Explorer
    demonstrator_explorer: Explorer
    env: CrowdSim


def build(config: Config, policy_name: str, base_seed: int = 0,
          device="cuda", policy_kwargs: Optional[dict] = None
          ) -> TrainerArtifacts:
    tc = config.train
    env = CrowdSim(config.env, device=device)
    policy = make_policy(policy_name, config.policy, config.env,
                         device=device, **(policy_kwargs or {}))
    if isinstance(policy, ModelPredictiveRLPolicy):
        trainer = MPRLTrainer(
            policy, optimizer=tc.optimizer,
            learning_rate=tc.rl_learning_rate,
            freeze_state_predictor=tc.freeze_state_predictor,
            detach_state_predictor=tc.detach_state_predictor,
            sp_update_stride=5 if tc.reduce_sp_update_frequency else 1)
    else:
        trainer = VNRLTrainer(policy, optimizer=tc.optimizer,
                              learning_rate=tc.rl_learning_rate)
    explorer = Explorer(env, policy, config.policy.gamma, base_seed)
    demonstrator = ORCARobotPolicy(config.policy, config.env,
                                   safety_space=tc.orca_safety_space,
                                   device=device)
    demo_explorer = Explorer(
        env, demonstrator, config.policy.gamma, base_seed,
        rotation_constraint=config.policy.action_space.rotation_constraint)
    return TrainerArtifacts(policy, trainer, explorer, demo_explorer, env)


def resume_rl(trainer, path: str, tc) -> None:
    """Restore an RL checkpoint into ``trainer`` as the reference resumes
    one (``train_loop.py:184-188``): the optimizer made from the config
    (``tc.optimizer`` at ``tc.rl_learning_rate``), then the checkpoint's
    parameters, target, moments and step count loaded into it. A
    checkpoint of another optimizer kind is refused."""
    trainer.set_learning_rate(tc.rl_learning_rate, tc.optimizer)
    ckpt.restore(path, trainer, keep_optimizer=True)


def optimizer_step(trainer) -> int:
    """The optimizer's step count (Adam's ``step``; 0 for SGD)."""
    state = trainer.optimizer.state[trainer.params[0]]
    return int(state["step"]) if "step" in state else 0


def train(config: Config, policy_name: str, output_dir: str,
          debug: bool = False, resume: bool = False, seed: int = 0,
          opts: Optional[LoopOptions] = None, device="cuda",
          art: Optional[TrainerArtifacts] = None) -> dict:
    """Run IL + RL -> the final validation metrics, with the phases' walls
    and key numbers. Checkpoints, ``metrics.jsonl`` and TensorBoard events
    land in ``output_dir``. ``art``: the artifacts to train (``build(config,
    policy_name, seed, device)``, made here when not given), for a caller
    that reads the live state afterwards."""
    opts = opts or LoopOptions()
    tc = config.train
    sim = config.env.sim
    if debug:  # the reference's debug shrink
        tc = dataclasses.replace(
            tc, il_episodes=20, il_epochs=2, rl_train_episodes=40,
            evaluation_interval=20, target_update_interval=20,
            checkpoint_interval=20, capacity=20_000)

    B, K, graphed = opts.train_envs, opts.collect_steps, opts.graphed
    mesh, comm = opts.mesh, opts.comm
    if mesh is not None and comm is not None:
        raise ValueError("a mesh of threads or a comm of processes, not both")
    data = mesh.data if mesh is not None else (comm.size if comm else 1)
    if B % data != 0:
        raise ValueError(
            f"train_envs={B} not divisible by data axis {data}")
    lead = comm is None or comm.rank == 0

    os.makedirs(output_dir, exist_ok=True)
    writer = MetricsWriter(output_dir) if lead else _NoWriter()
    art = art or build(config, policy_name, base_seed=seed, device=device)
    policy, trainer, explorer = art.policy, art.trainer, art.explorer
    demo_explorer = art.demonstrator_explorer

    policy.init_params(torch.Generator().manual_seed(seed))
    trainer.update_target()
    collectors: dict = {}
    if mesh is not None or comm is not None:
        trainer = ParallelTrainer(trainer, mesh=mesh, comm=comm)
        collectors = {id(e): ParallelCollect(
            e, K, sim.train_seed_offset, mesh=mesh, comm=comm)
            for e in (explorer, demo_explorer)}
        log.info("mesh: %s", mesh.shape if mesh is not None else
                 {"data": comm.size, "model": 1, "processes": True})

    def save(path: str) -> None:
        if lead:
            ckpt.save(path, trainer)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_params = sum(p.numel() for p in trainer.params)
    log.info("policy %s: %d parameters", policy_name, n_params)

    buffer = rb.create(tc.capacity, sim.human_num, device=device)
    result: dict = {}

    def collect_and_update(expl: Explorer, carry, epsilon: float,
                           imitation: bool, draws=None):
        if collectors:
            carry, traj = collectors[id(expl)](carry, epsilon, draws,
                                               graphed)
        else:
            carry, traj = expl.collect(carry, K, sim.train_seed_offset,
                                       epsilon, draws, graphed)
        expl.update_memory(buffer, traj,
                           None if imitation else trainer.target.value,
                           imitation)
        stats = {k: float(v) for k, v in expl.count_episodes(traj).items()}
        return carry, stats

    def evaluate(n_val: int) -> EvalStats:
        ev = explorer.run_cases(sim.val_seed_offset, range(n_val),
                                graphed=graphed)
        return EvalStats(*(float(x) for x in ev))

    # ---------------------------------------------------------- phase 1: IL
    trainer.set_learning_rate(tc.il_learning_rate, tc.il_optimizer)
    il_ckpt = os.path.join(output_dir, "il_model")
    rl_ckpt = os.path.join(output_dir, "rl_model")
    resumed_rl = False
    t_il = time.perf_counter()
    if resume and ckpt.exists(rl_ckpt):
        resume_rl(trainer, rl_ckpt, tc)
        resumed_rl = True
        log.info("resumed RL checkpoint from %s (%s at rate %g, step %d)",
                 rl_ckpt, art.trainer.optimizer_name,
                 art.trainer.learning_rate, optimizer_step(art.trainer))
    elif resume and ckpt.exists(il_ckpt):
        ckpt.restore(il_ckpt, trainer)
        log.info("resumed IL checkpoint from %s", il_ckpt)
    else:
        t0 = time.perf_counter()
        carry = demo_explorer.init_carry(B, sim.train_seed_offset)
        episodes = 0
        demo_successes = 0.0
        while episodes < tc.il_episodes:
            carry, stats = collect_and_update(demo_explorer, carry, 0.0, True)
            ep_inc = int(stats["episodes"])
            episodes += ep_inc
            demo_successes += stats["success_rate"] * ep_inc
        demo_success = demo_successes / max(episodes, 1)
        result["demo_success"] = demo_success
        log.info("IL demonstrations: %d episodes (success %.2f) in %.1fs",
                 episodes, demo_success, time.perf_counter() - t0)
        # a failing demonstrator poisons the value function silently (e.g.
        # an action stream of the wrong kinematics): abort before imitating
        if demo_success < 0.7:
            raise RuntimeError(
                f"IL demonstrator success {demo_success:.2f} < 0.7 — "
                "demonstrations are unusable (check robot kinematics vs "
                "demonstrator action convention); aborting before IL.")

        # epoch sweeps sized to the filled buffer
        steps = max(tc.il_epochs * max(buffer.size // tc.batch_size, 1), 1)
        t0 = time.perf_counter()
        sums = torch.zeros(2, device=buffer.data.reward.device)
        for start in range(0, steps, IL_CHUNK):
            n = min(IL_CHUNK, steps - start)
            idx = rb.sample_indices(buffer, gen, (n, tc.batch_size))
            aux = trainer.optimize(buffer, idx, use_td=False, sp_always=True,
                                   graphed=graphed)
            sums += torch.stack(aux) * n
        aux = LossAux(*(sums / steps).tolist())
        trainer.update_target()
        log.info("IL: %d sgd steps, value loss %.4f, sp loss %.4f (%.1fs)",
                 steps, aux.value_loss, aux.predictor_loss,
                 time.perf_counter() - t0)
        writer.write(0, {"value_loss": aux.value_loss,
                         "sp_loss": aux.predictor_loss}, prefix="il")
        result.update(il_sgd_steps=steps, il_value_loss=aux.value_loss,
                      il_sp_loss=aux.predictor_loss)
        save(il_ckpt)

        ev = evaluate(min(sim.val_size, opts.eval_envs))
        result["il_val_success"] = ev.success_rate
        log.info("IL val: success %.2f coll %.2f nav %.2fs ret %.3f",
                 ev.success_rate, ev.collision_rate, ev.avg_nav_time,
                 ev.avg_return)
    result["il_wall_s"] = time.perf_counter() - t_il

    # ---------------------------------------------------------- phase 2: RL
    if not resumed_rl:  # a fresh optimizer; params and target carry over
        trainer.set_learning_rate(tc.rl_learning_rate, tc.optimizer)

    carry = explorer.init_carry(B, sim.train_seed_offset)
    episodes = 0
    it = 0
    opt_debt = 0  # episodes whose train_batches sweep is still owed
    aux = LossAux(torch.zeros(()), torch.zeros(()))
    last_eval_ep = -1
    last_target_ep = 0
    last_ckpt_ep = 0
    best_score = (-1.0, float("-inf"))  # lexicographic (success, return)
    best_ckpt = os.path.join(output_dir, "rl_model_best")
    # wall seconds of collection, SGD sweeps and validation; each part ends
    # in a host sync (the episode count, the loss, the metrics)
    walls = {k: profiling.Stopwatch("rl." + k)
             for k in ("collect", "sgd", "val")}
    t_loop = time.perf_counter()
    while episodes < tc.rl_train_episodes:
        with walls["collect"]:
            frac = min(episodes / tc.epsilon_decay, 1.0)
            epsilon = tc.epsilon_start + frac * (tc.epsilon_end
                                                 - tc.epsilon_start)
            carry, stats = collect_and_update(explorer, carry, epsilon,
                                              False,
                                              explorer.draws(gen, K, B))
            ep_inc = int(stats["episodes"])
        episodes += ep_inc

        with walls["sgd"]:
            # the reference optimizes train_batches minibatches after every
            # episode: one sweep owed for each episode this iteration
            # finished
            opt_debt += ep_inc
            while opt_debt > 0:
                aux = trainer.optimize_batches(buffer, gen, tc.train_batches,
                                               tc.batch_size,
                                               graphed=graphed)
                opt_debt -= 1
                it += 1

            if episodes - last_target_ep >= tc.target_update_interval:
                trainer.update_target()
                last_target_ep = episodes

            value_loss = float(aux.value_loss)
            sp_loss = float(aux.predictor_loss)
        if episodes // tc.evaluation_interval > last_eval_ep // max(
                tc.evaluation_interval, 1) or last_eval_ep < 0:
            with walls["val"]:
                n_val = min(sim.val_size, opts.eval_envs) if debug \
                    else sim.val_size
                ev = evaluate(n_val)
                log.info(
                    "RL ep %d it %d eps %.2f | val success %.2f coll %.2f "
                    "nav %.2fs ret %.3f | vloss %.4f sploss %.4f | %.1fs",
                    episodes, it, epsilon, ev.success_rate,
                    ev.collision_rate, ev.avg_nav_time, ev.avg_return,
                    value_loss, sp_loss, time.perf_counter() - t_loop)
                writer.write(episodes, {
                    "success_rate": ev.success_rate,
                    "collision_rate": ev.collision_rate,
                    "timeout_rate": ev.timeout_rate,
                    "nav_time": ev.avg_nav_time,
                    "return": ev.avg_return}, prefix="val")
                last_eval_ep = episodes
                # the best-on-val snapshot; the discounted return breaks
                # ties of success toward faster, calmer navigation
                score = (ev.success_rate, ev.avg_return)
                if score > best_score:
                    best_score = score
                    save(best_ckpt)
                    log.info("new best val success %.2f → %s",
                             ev.success_rate, best_ckpt)
        writer.write(episodes, {
            "value_loss": value_loss, "sp_loss": sp_loss,
            "epsilon": epsilon, "train_success": stats["success_rate"]},
            prefix="rl")

        if episodes - last_ckpt_ep >= tc.checkpoint_interval:
            save(rl_ckpt)
            last_ckpt_ep = episodes

    save(rl_ckpt)
    result.update(rl_wall_s=time.perf_counter() - t_loop, rl_sgd_steps=it
                  * tc.train_batches, value_loss=float(aux.value_loss),
                  sp_loss=float(aux.predictor_loss),
                  **{f"rl_{k}_s": w.seconds for k, w in walls.items()})
    log.info("RL: %d episodes, %d sgd steps in %.1fs: collection %.1fs, "
             "sgd %.1fs, validation %.1fs", episodes, result["rl_sgd_steps"],
             result["rl_wall_s"], walls["collect"].seconds,
             walls["sgd"].seconds, walls["val"].seconds)

    ev = evaluate(min(sim.val_size, 500))
    final = {
        "success_rate": ev.success_rate,
        "collision_rate": ev.collision_rate,
        "timeout_rate": ev.timeout_rate,
        "nav_time": ev.avg_nav_time,
        "return": ev.avg_return,
        "episodes": episodes,
    }
    log.info("final val: %s", final)
    writer.close()
    return {**final, **result}
