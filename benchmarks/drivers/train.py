"""MP-RGL's RL training, one RL iteration a call, as
``training/train_loop.py`` runs it: ``Explorer.collect`` of B envs × K
steps at ε (graphed), ``update_memory`` with the target net's TD values,
``count_episodes``, then one ``MPRLTrainer.optimize_batches`` sweep
(graphed) for every episode the iteration finished, and the target net's
update every ``target_update_interval`` episodes. Validation is the
evaluation cell's work and runs not here. Work: the episodes finished.

Set-up loads the checkpoint into the policy and the target, fills the
buffer with the cell's own collection, and then drives the SGD step from
those weights through its first steps with the window's own call
(``optimize_batches``, one minibatch each), on minibatches of the seed's
drawing: the reference follows them from the same weights and rows. The
window then trains the same objects on. Its SGD step (the captured step on
the card, ``_sgd_step`` on the CPU) is wrapped by a recorder that keeps,
around the first step of one window sweep the seed picks, the trainer's
live state (parameters, Adam's moments and step count, the target) before
and after, and the step's minibatch rows: the reference follows that step
from the same state and rows.

After the window the reference judges a seeded sample of the window's
transitions from the state the program was in: the decision (with the
iteration's parameters; an explored one exactly), the env step from the
full states (the human's goal, v_pref and heading from its case, which the
reference regenerates), and the TD value written to the buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.counters import flops
from benchmarks.drivers import common, mprl_judge
from benchmarks.reference import mprl as ref
from benchmarks.reference import scenarios

BETA1 = 0.9  # Adam's first moment after one step is (1 − β1)·g


def median_gap(prog: dict, ref: dict) -> float:
    """The median over the leaves of |‖prog‖ − ‖ref‖| / ‖ref‖."""
    gaps = []
    for k, r in ref.items():
        rn = float(r.double().norm())
        gaps.append(abs(float(prog[k].double().norm()) - rn) / max(rn, 1e-30))
    return float(np.median(gaps))


def tiny(cfg: dict, traffic: dict) -> None:
    """Cut a configuration and mix in place to a CPU test's size: 2 envs ×
    4 steps over 64 cases, a buffer of 16 from a 1-s episode, 2 minibatches
    a sweep; one iteration, 3 transitions and 1 sweep judged."""
    traffic.update(train_envs=2, collect_steps=4, case_table=64)
    traffic["check"].update(iterations=1, transitions=3, sweeps=1)
    cfg["buffer_fill"] = 16
    cfg["env"]["time_limit"] = 1.0  # the window's call ends episodes
    cfg["train"].update(train_batches=2, capacity=1000)


class _SweepRecorder:
    """The SGD step as ``optimize_batches`` calls it, keeping the state
    around the first step of the ``pick``-th sweep (the program's own
    step, unchanged)."""

    def __init__(self, step, trainer, buffer, steps_per_sweep: int,
                 pick: int):
        self.step, self.trainer, self.buffer = step, trainer, buffer
        self.at = steps_per_sweep * pick
        self.seen = 0
        self.kept = None

    def state(self) -> dict:
        tr = self.trainer
        st = tr.optimizer.state
        return {"params": [p.detach().clone() for p in tr.params],
                "m": [st[p]["exp_avg"].clone() for p in tr.params],
                "v": [st[p]["exp_avg_sq"].clone() for p in tr.params],
                "t": st[tr.params[0]]["step"].clone(),
                "target": [p.detach().clone()
                           for p in tr.target.parameters()]}

    def __call__(self, *args):
        keep = self.seen == self.at
        if keep:  # the captured step's (idx, sp), or _sgd_step's last two
            idx, sp = args[-2], args[-1]
            before = self.state()
            rows = {f: getattr(self.buffer.data, f)[idx].clone()
                    for f in self.buffer.data._fields}
        out = self.step(*args)
        if keep:
            self.kept = {"before": before, "after": self.state(),
                         "rows": rows, "sp": sp.clone(),
                         "losses": self.trainer.aux_sum.clone()}
        self.seen += 1
        return out


class Driver:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.traffic = ctx, ctx.config, ctx.traffic
        self.iterations: list = []

    # -------------------------------------------------------------- set-up
    def setup(self) -> None:
        from relationalgraphlearning_tpu_torch.convert import tree_from_flat
        from relationalgraphlearning_tpu_torch.training import (
            replay_buffer as rb)
        from relationalgraphlearning_tpu_torch.training import train_loop
        config = common.port_config(self.cfg)
        tr, dev = self.traffic, self.ctx.device
        self.cuda = torch.device(dev).type == "cuda"
        self.graphed = self.cuda
        self.config, self.seed32 = config, self.ctx.seed & common.SEED_MASK
        art = train_loop.build(config, "model_predictive_rl",
                               base_seed=self.seed32, device=dev)
        self.policy, self.trainer = art.policy, art.trainer
        self.explorer = art.explorer
        self.arrays = common.checkpoint_arrays(self.cfg)
        self.policy.load_flax(tree_from_flat(self.arrays))
        self.trainer.update_target()
        self.names = list(self.trainer.names)
        tc = config.train
        self.buffer = rb.create(tc.capacity, config.env.sim.human_num,
                                device=dev)
        self.offset = config.env.sim.train_seed_offset
        self.explorer.case_table(self.offset).ensure(tr["case_table"])
        self.B, self.K = tr["train_envs"], tr["collect_steps"]
        self.eps = tr["epsilon"]
        self.gen = torch.Generator(device=dev).manual_seed(self.ctx.seed)
        self.draw_gen = torch.Generator(device=dev).manual_seed(
            self.ctx.seed + 1)
        self.actions = self.policy.action_space
        self.carry = self.explorer.init_carry(self.B, self.offset)
        self.episodes = self.last_target = 0
        self.target_version = 0
        while self.buffer.size < self.cfg["buffer_fill"]:
            self.iterate()
        self.iterations.clear()
        self.first_steps()
        pick = int(common.check_rng(self.ctx.seed).integers(
            tr["check"]["sweeps"]))
        t = self.trainer
        if self.cuda:
            key = (tc.batch_size, t.rl_recomputes_td)
            held, step = t._graphs[key]
            self.recorder = _SweepRecorder(step, t, self.buffer,
                                           tc.train_batches, pick)
            t._graphs[key] = (held, self.recorder)
        else:  # the eager loop calls the step itself
            self.recorder = _SweepRecorder(t._sgd_step, t, self.buffer,
                                           tc.train_batches, pick)
            t._sgd_step = self.recorder

    def first_steps(self) -> None:
        """The SGD step's first steps from the loaded weights, each through
        ``optimize_batches`` with one minibatch; kept for the check."""
        tr, tc = self.traffic, self.config.train
        shadow = torch.Generator(device=self.ctx.device)
        self.sgd = {"rows": [], "losses": []}
        for i in range(tr["check"]["sgd_steps"]):
            shadow.set_state(self.gen.get_state())
            idx = torch.randint(0, max(self.buffer.size, 1),
                                (1, tc.batch_size), generator=shadow,
                                device=self.ctx.device)[0]
            aux = self.trainer.optimize_batches(self.buffer, self.gen, 1,
                                                tc.batch_size,
                                                graphed=self.graphed)
            self.sgd["losses"].append((float(aux.value_loss),
                                       float(aux.predictor_loss)))
            self.sgd["rows"].append({f: getattr(self.buffer.data, f)[idx]
                                     .clone() for f in
                                     self.buffer.data._fields})
            if i == 0:
                st = self.trainer.optimizer.state
                self.sgd["grads"] = [st[p]["exp_avg"].clone() / (1 - BETA1)
                                     for p in self.trainer.params]
        self.sgd["params"] = [p.detach().clone()
                              for p in self.trainer.params]

    # -------------------------------------------------------------- window
    def draws(self):
        A = self.actions.shape[0]
        return (torch.randint(0, A, (self.K, self.B), generator=self.draw_gen,
                              device=self.ctx.device),
                torch.rand((self.K, self.B), generator=self.draw_gen,
                           device=self.ctx.device))

    def iterate(self) -> int:
        ex = self.explorer
        draws = self.draws()
        record = {"carry": self.carry, "draws": draws,
                  "ptr": self.buffer.ptr,
                  "params": [p.detach().clone() for p in
                             self.trainer.params],
                  "target": self.target_version}
        self.carry, traj = ex.collect(self.carry, self.K, self.offset,
                                      self.eps, draws, self.graphed)
        ex.update_memory(self.buffer, traj, self.trainer.target.value, False)
        done = int(ex.count_episodes(traj)["episodes"])
        record["traj"] = traj
        self.iterations.append(record)
        self.episodes += done
        return done

    def call(self, win) -> None:
        tc = self.config.train
        with win.span("collect"):
            done = self.iterate()
        win.count("episodes", done)
        win.count("model_flops", self.B * self.K * (
            flops.decision(self.cfg) + flops.mprl_value(self.cfg)))
        if done == 0:
            return
        with win.span("sgd"):
            for _ in range(done):
                aux = self.trainer.optimize_batches(
                    self.buffer, self.gen, tc.train_batches, tc.batch_size,
                    graphed=self.graphed)
                win.boundary()
            if self.episodes - self.last_target >= tc.target_update_interval:
                self.trainer.update_target()
                self.last_target = self.episodes
                self.target_version += 1
            float(aux.value_loss)
        win.count("sgd_steps", done * tc.train_batches)
        win.count("model_flops", done * tc.train_batches
                  * flops.sgd_step(self.cfg))

    def end_to_end(self, obs) -> dict:
        return {"rl_episodes_per_s": obs.counters["episodes"]
                / obs.window_s}

    def release(self) -> None:
        self.buffer_value = self.buffer.data.value.clone()
        self.sweep = self.recorder.kept
        del self.policy, self.trainer, self.explorer, self.buffer

    # --------------------------------------------------------------- check
    def check(self, control: bool = False) -> list:
        lim = self.traffic["check"]["limits"]
        return self.check_sgd(control, lim) + self.check_collection(
            control, lim)

    def check_sgd(self, control: bool, lim: dict, half: bool = False
                  ) -> list:
        """The first steps from the checkpoint's weights, and the first step
        of the picked window sweep from the state the program was in,
        against the reference's from the same state and rows. ``control``:
        the reference in TF32 in the program's place; ``half``: the
        reference over the first half of each minibatch in the program's
        place (a fault's reading)."""
        P0 = common.to_device(self.arrays, self.ctx.device)
        first = self.sgd
        got = None if (half or control) else {
            "losses": first["losses"],
            "grads": common.as_reference(self.names, first["grads"]),
            "params": common.as_reference(self.names, first["params"])}
        loss, grad, step = self.follow(P0, P0, first["rows"], None, got,
                                       control, half)
        out = [("first_loss_rel", loss, lim["first_loss_rel"]),
               ("first_grad_median_gap", grad, lim["first_grad_median_gap"]),
               ("update_median_gap", step, lim["update_median_gap"])]
        k = self.sweep
        if k is None:  # the window ended before the picked sweep
            return out + [("sweep_judged", 1.0, 0.0)]
        R = lambda ts: common.as_reference(self.names, ts)  # noqa: E731
        b, a = k["before"], k["after"]
        m0 = R(b["m"])
        state = (m0, R(b["v"]), int(round(float(b["t"]))))
        got = None if (half or control) else {
            "losses": [tuple(k["losses"].tolist())],
            # the clipped gradient as Adam got it: m1 = β1·m0 + (1 − β1)·g
            "grads": {n: (m1 - BETA1 * m0[n]) / (1 - BETA1)
                      for n, m1 in R(a["m"]).items()},
            "params": R(a["params"])}
        loss, grad, step = self.follow(
            R(b["params"]), R(b["target"]), [k["rows"]], state, got,
            control, half, [float(k["sp"])])
        return out + [("sweep_loss_rel", loss, lim["sweep_loss_rel"]),
                      ("sweep_grad_median_gap", grad,
                       lim["sweep_grad_median_gap"]),
                      ("sweep_update_median_gap", step,
                       lim["sweep_update_median_gap"]),
                      ("sweep_judged", 0.0, 0.0)]

    def follow(self, P, target, rows, state, got, control, half, sp=None
               ) -> tuple[float, float, float]:
        """The reference's steps from ``P`` (and Adam's ``state``) on
        ``rows`` against ``got`` (the program's; the reference's in TF32
        for ``control``, over half of each minibatch for ``half``) -> the
        first step's losses (relative), and the median over the leaves of
        each leaf's gap in its gradient and in its change.

        The median over the leaves: a leaf whose gradient is mostly
        rounding (Adam's first steps make its change as large as any
        leaf's) carries noise that the worst leaf, or the leaf of median
        size, would read (PERF.md §2)."""
        sp = sp or [1.0] * len(rows)
        want = ref.train_steps(P, target, rows, sp, self.cfg, state)
        if half:
            got = ref.train_steps(P, target, [{k: v[:v.shape[0] // 2]
                                               for k, v in r.items()}
                                              for r in rows], sp, self.cfg,
                                  state)
        elif control:
            with mprl_judge.tf32():
                got = ref.train_steps(P, target, rows, sp, self.cfg, state)
        loss = max(abs(g - w) / max(abs(w), 1e-30)
                   for g, w in zip(got["losses"][0], want["losses"][0]))
        gnorm = {k: float(v.double().norm())
                 for k, v in want["grads"].items()}
        med = float(np.median(list(gnorm.values())))
        moved = [k for k, v in gnorm.items() if v >= 1e-3 * med]
        grad = median_gap({k: got["grads"][k] for k in moved},
                          {k: want["grads"][k] for k in moved})
        step = median_gap({k: got["params"][k] - P[k] for k in moved},
                          {k: want["params"][k] - P[k] for k in moved})
        return loss, grad, step

    def sampled(self) -> list:
        """A seeded sample of the window's transitions: (iteration, step,
        env)."""
        rng = common.check_rng(self.ctx.seed)
        chk = self.traffic["check"]
        return [(i, t, b)
                for i in common.sample(rng, len(self.iterations),
                                       chk["iterations"])
                for t, b in [divmod(int(j), self.B) for j in
                             common.sample(rng, self.K * self.B,
                                           chk["transitions"])]]

    def check_collection(self, control: bool, lim: dict) -> list:
        dev, env, B = self.ctx.device, self.cfg["env"], self.B
        cfg_attrs = scenarios.attrs(env)
        P0 = common.to_device(self.arrays, dev)
        gap = err = td = 0.0
        bad = 0
        for i, t, b in self.sampled():
            it = self.iterations[i]
            traj = it["traj"]
            # the case env b plays at step t: its case at the iteration's
            # start, moved on by B at each earlier terminal
            case = int(it["carry"].case_counter[b]) - B + B * int(
                traj.terminal[:t, b].sum())
            key = scenarios.case_key(self.seed32, self.offset,
                                     np.array([case]))
            _, humans0 = scenarios.generate_cases(key, cfg_attrs)
            fixed = torch.as_tensor(humans0[0, :, 5:], device=dev)
            robot = traj.robot[t, b][None]
            obs_h = traj.humans[t, b][None]
            humans = torch.cat([obs_h, fixed[None]], -1)
            step = traj.ep_step[t, b][None]
            act = traj.action[t, b][None]
            P = common.as_reference(self.names, it["params"])
            planner = ref.Planner(self.cfg, P, dev)
            u, a_idx = it["draws"][1][t, b], it["draws"][0][t, b]
            explored = (u < self.eps)[None]
            explore_act = planner.actions[a_idx][None]
            if control:
                act = torch.where(explored[:, None], explore_act,
                                  mprl_judge.control_actions(planner, robot,
                                                             obs_h))
            gap = max(gap, mprl_judge.decision_gap(
                planner, robot, obs_h, act, explored, explore_act))
            out = ref.in_precision(torch.bfloat16, ref.env_step, robot,
                                   humans, step, act, env) if control \
                else ref.env_step(robot, humans, step, act, env)
            nxt = (out.robot, out.humans[..., :5], out.reward, out.done,
                   out.outcome) if control else (
                traj.next_robot[t, b][None], traj.next_humans[t, b][None],
                traj.reward[t, b][None], traj.terminal[t, b][None],
                traj.outcome[t, b][None])
            e, k = mprl_judge.step_errors(env, robot, humans, step, act,
                                          nxt[0], nxt[1], nxt[3], nxt[4],
                                          nxt[2])
            err, bad = max(err, e), bad + k
            # the TD value the program wrote for this transition
            if it["target"] == 0:
                row = (it["ptr"] + t * B + b) % self.cfg["train"]["capacity"]
                batch = {"robot": robot, "next_robot": nxt[0],
                         "next_humans": nxt[1], "reward": nxt[2],
                         "terminal": nxt[3].float()}
                want = ref.td_target(batch, P0, self.cfg)
                if control:
                    with mprl_judge.tf32():
                        got = ref.td_target(batch, P0, self.cfg)
                else:
                    got = self.buffer_value[row][None]
                td = max(td, float((got - want).abs().max()))
        return [("decision_gap", gap, lim["decision_gap"]),
                ("step_err", err, lim["step_err"]),
                ("outcome_mismatch", float(bad), 0.0),
                ("td_value_err", td, lim["td_value_err"])]
