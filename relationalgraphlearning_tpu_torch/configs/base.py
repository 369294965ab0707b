"""Configuration dataclasses of the PyTorch port.

A copy of ``relationalgraphlearning_tpu/configs/base.py``: the same frozen
dataclasses with the same field names and defaults, so a config written for
the JAX package reads the same here. The port keeps its own copy because it
imports nothing of the JAX package; ``tests/test_torch_configs.py`` holds the
two copies equal field by field.
"""

from __future__ import annotations

import ast
import dataclasses
import types
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class RewardConfig:
    success_reward: float = 1.0
    collision_penalty: float = -0.25
    discomfort_dist: float = 0.2
    discomfort_penalty_factor: float = 0.5


@dataclass(frozen=True)
class SimConfig:
    """Scenario generation. Parity: CrowdSim.configure / generate_human."""

    scenario: str = "circle_crossing"  # or "square_crossing"
    human_num: int = 5
    circle_radius: float = 4.0
    square_width: float = 10.0
    # case counter offsets per phase — parity with CrowdSim seeded cases:
    # train/val/test draw from disjoint reproducible scenario sets.
    val_size: int = 100
    test_size: int = 500
    # per-phase seed offsets (reference uses {'train': case_capacity, 'val': 0,
    # 'test': case_capacity + val_size}-style offsets; exact values are free —
    # disjointness is the requirement).
    train_seed_offset: int = 1_000_000
    val_seed_offset: int = 0
    test_seed_offset: int = 100_000


@dataclass(frozen=True)
class EnvConfig:
    time_limit: float = 25.0
    time_step: float = 0.25
    reward: RewardConfig = field(default_factory=RewardConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    # robot
    robot_visible: bool = False
    robot_radius: float = 0.3
    robot_v_pref: float = 1.0
    robot_kinematics: str = "holonomic"
    # humans
    human_policy: str = "orca"  # "orca" | "socialforce" | "linear" | "mixed"
    # "mixed": first ceil(frac*N) humans run ORCA, the rest social force
    # (BASELINE config #4: mixed ORCA/SFM crowds)
    mixed_orca_fraction: float = 0.5
    human_radius: float = 0.3
    human_v_pref: float = 1.0
    randomize_attributes: bool = False
    # ORCA params for humans (parity: crowd_sim/envs/policy/orca.py defaults)
    orca_neighbor_dist: float = 10.0
    orca_time_horizon: float = 5.0
    orca_safety_space: float = 0.0
    # max episode steps = time_limit / time_step
    @property
    def max_steps(self) -> int:
        return int(round(self.time_limit / self.time_step))


@dataclass(frozen=True)
class GCNConfig:
    """Parity: config keys ``gcn.*`` consumed by graph_model.py (SURVEY §2.2)."""

    X_dim: int = 32
    num_layer: int = 2
    similarity_function: str = "embedded_gaussian"
    robot_state_dim: int = 9
    human_state_dim: int = 5
    wr_dims: Tuple[int, ...] = (64, 32)
    wh_dims: Tuple[int, ...] = (64, 32)
    final_state_dim: int = 32
    gcn2_w1_dim: int = 32
    planning_dims: Tuple[int, ...] = (150, 100, 100, 1)
    skip_connection: bool = False
    layerwise_graph: bool = True


@dataclass(frozen=True)
class ActionSpaceConfig:
    """Parity: CADRL.build_action_space — speed_samples exponentially spaced
    speeds x rotation_samples directions + stop (SURVEY §2.2)."""

    speed_samples: int = 5
    rotation_samples: int = 16
    rotation_constraint: float = 3.14159265 / 4  # unicycle only


@dataclass(frozen=True)
class MPRLConfig:
    """Parity: config keys ``model_predictive_rl.*`` (SURVEY §2.2)."""

    planning_depth: int = 2
    planning_width: int = 2
    do_action_clip: bool = True
    # sparse_search: action_clip picks top-value actions subject to coarse
    # (speed, rotation)-bucket diversity instead of plain top-k (parity:
    # ModelPredictiveRL.action_clip's sparse_search branch with its hardcoded
    # sparse_speed_samples=2 / sparse_rotation_samples=8).
    sparse_search: bool = False
    sparse_speed_samples: int = 2
    sparse_rotation_samples: int = 8
    share_graph_model: bool = False
    linear_state_predictor: bool = False
    motion_predictor_dims: Tuple[int, ...] = (64, 5)
    value_network_dims: Tuple[int, ...] = (32, 100, 100, 1)
    # Canonicalize network inputs into the goal frame (origin at robot,
    # x-axis at the goal) before the RGL nets; predictions rotate back to
    # world. A pure symmetry reduction (the env is isotropic) — the
    # reference's CADRL.rotate insight applied to the whole MPRL stack;
    # decisive for unicycle kinematics, where the raw-coordinate nets must
    # otherwise learn the heading dimension (SURVEY §2.2 rotate).
    canonicalize: bool = False


@dataclass(frozen=True)
class PolicyConfig:
    name: str = "model_predictive_rl"
    gamma: float = 0.9
    gcn: GCNConfig = field(default_factory=GCNConfig)
    action_space: ActionSpaceConfig = field(default_factory=ActionSpaceConfig)
    mprl: MPRLConfig = field(default_factory=MPRLConfig)
    # SARL / CADRL / LSTM-RL baseline knobs
    cadrl_mlp_dims: Tuple[int, ...] = (150, 100, 100, 1)
    sarl_mlp1_dims: Tuple[int, ...] = (150, 100)
    sarl_mlp2_dims: Tuple[int, ...] = (100, 50)
    sarl_attention_dims: Tuple[int, ...] = (100, 100, 1)
    sarl_mlp3_dims: Tuple[int, ...] = (150, 100, 100, 1)
    sarl_with_global_state: bool = True
    lstm_hidden_dim: int = 50
    lstm_mlp_dims: Tuple[int, ...] = (150, 100, 100, 1)
    lstm_with_interaction_module: bool = False
    lstm_mlp1_dims: Tuple[int, ...] = (150, 100, 100, 50)
    with_om: bool = False
    om_cell_num: int = 4
    om_cell_size: float = 1.0
    om_channel_size: int = 3
    # one-step baselines: propagate humans through the env's privileged
    # one-step lookahead (parity: MultiHumanRL.predict query_env=True →
    # env.onestep_lookahead) instead of constant velocity.
    query_env: bool = False


@dataclass(frozen=True)
class TrainConfig:
    # imitation learning (parity: train.py phase 1)
    il_episodes: int = 2000
    il_epochs: int = 50
    il_learning_rate: float = 0.01
    il_optimizer: str = "sgd"  # parity: reference pretrains with SGD+momentum
    orca_safety_space: float = 0.15  # demonstrator safety space
    # rl (parity: train.py phase 2)
    rl_train_episodes: int = 10000
    rl_learning_rate: float = 0.001
    # gradient minibatches run per completed episode (parity: train.py calls
    # trainer.optimize_batch(train_batches) after every sampled episode)
    train_batches: int = 100
    target_update_interval: int = 1000
    evaluation_interval: int = 1000
    checkpoint_interval: int = 1000
    epsilon_start: float = 0.5
    epsilon_end: float = 0.1
    epsilon_decay: float = 4000.0
    capacity: int = 100_000
    batch_size: int = 100
    optimizer: str = "adam"
    # state-predictor update schedule (parity: MPRLTrainer knobs)
    reduce_sp_update_frequency: bool = False
    freeze_state_predictor: bool = False
    detach_state_predictor: bool = False


@dataclass(frozen=True)
class Config:
    env: EnvConfig = field(default_factory=EnvConfig)
    policy: PolicyConfig = field(default_factory=PolicyConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


_JAX_PACKAGE = "relationalgraphlearning_tpu"
_JAX_CONFIGS = _JAX_PACKAGE + ".configs.base"


def _point_at_the_port(tree: ast.Module, path: str) -> ast.Module:
    """Rewrite ``from relationalgraphlearning_tpu.configs.base import ...``
    to this module; raise on any other import of the JAX package (importing
    it would import JAX)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == _JAX_CONFIGS \
                and node.level == 0:
            node.module = __name__
            continue
        if isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        for name in names:
            if name.split(".")[0] == _JAX_PACKAGE:
                raise ImportError(
                    f"{path}:{node.lineno} imports {name}; a config file may "
                    f"import only {_JAX_CONFIGS} of the JAX package")
    return tree


def load_config_module(path: str):
    """Load a Python config file by path; it must expose ``get_config() ->
    Config`` (or a module-level ``config``). Parity: train.py's
    ``importlib.util.spec_from_file_location`` config loading.

    Config files written for the JAX package import
    ``relationalgraphlearning_tpu.configs.base``, whose package imports JAX.
    The source is parsed instead, that import is pointed at this module, and
    the file is compiled and run as a module of its own."""
    with open(path) as f:
        tree = _point_at_the_port(ast.parse(f.read(), filename=path), path)
    mod = types.ModuleType("rgl_torch_user_config")
    mod.__file__ = path
    exec(compile(tree, path, "exec"), mod.__dict__)
    if hasattr(mod, "get_config"):
        return mod.get_config()
    if hasattr(mod, "config"):
        return mod.config
    raise AttributeError(f"config module {path} defines neither get_config() nor config")


def replace(cfg, **kw):
    """Convenience wrapper over dataclasses.replace for nested updates."""
    return dataclasses.replace(cfg, **kw)
