"""The seeded scenarios of the crowd env, in NumPy: a frozen copy of the
port's ``envs/scenarios.py`` (circle and square crossing, each human placed
by a 12-attempt rejection sampler, every draw from a per-case threefry2x32
key ``fold_in(PRNGKey(seed), offset + case)``). The benchmark regenerates
the cases with it to check the program's starting states. ``cfg`` is the
configuration's ``env`` group as attributes (``attrs``)."""

from __future__ import annotations

import types

import numpy as np

PX, PY, RADIUS, GX, GY, VPREF = 0, 1, 4, 5, 6, 7


def attrs(group):
    """A configuration group (nested dicts) with attribute access."""
    if isinstance(group, dict):
        return types.SimpleNamespace(**{k: attrs(v) for k, v in group.items()})
    return group

_ATTEMPTS = 12  # fixed rejection-sampling budget per human
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_F32 = np.float32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key ``(k1, k2)``; uint32 arrays, broadcast together."""
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, np.uint32)
                                           for a in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        a, b = x1 + ks[0], x2 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def prng_key(seed) -> np.ndarray:
    """``jax.random.PRNGKey(uint32 seed)``: [..., 2] = (0, seed)."""
    seed = np.asarray(seed, np.uint32)
    return np.stack([np.zeros_like(seed), seed], axis=-1)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter (0, data)."""
    a, b = threefry2x32(key[..., 0], key[..., 1], 0, np.asarray(data,
                                                                np.uint32))
    return np.stack([a, b], axis=-1)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` in the partitionable mode: key i is the hash of
    the counter (0, i). [..., 2] -> [..., num, 2]."""
    i = np.arange(num, dtype=np.uint32)
    a, b = threefry2x32(key[..., None, 0], key[..., None, 1], 0, i)
    return np.stack([a, b], axis=-1)


def random_bits(key: np.ndarray) -> np.ndarray:
    """32 random bits of one scalar draw (counter (0, 0)): the two hash
    words XORed."""
    a, b = threefry2x32(key[..., 0], key[..., 1], 0, 0)
    return a ^ b


def uniform(key: np.ndarray, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, (), minval=..., maxval=...)`` in float32:
    the top 23 bits as the mantissa of a float in [1, 2), less 1, scaled.

    The reference's compiler fuses the scale and shift into one fused
    multiply-add; the float64 sum here is exact (a product of two float32
    and a float32 of like size), so one rounding to float32 matches it."""
    bits = (random_bits(key) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - _F32(1.0)
    lo, hi = _F32(minval), _F32(maxval)
    scaled = floats.astype(np.float64) * (hi - lo) + np.float64(lo)
    return np.maximum(lo, scaled.astype(_F32))


def case_key(base_seed: int, phase_offset: int, case_idx) -> np.ndarray:
    """Per-case key ``fold_in(PRNGKey(seed), offset + idx)`` [..., 2]."""
    data = np.asarray(phase_offset + np.asarray(case_idx, np.int64))
    return fold_in(prng_key(base_seed), data.astype(np.uint32))


def _norm(v: np.ndarray) -> np.ndarray:
    return np.sqrt((v * v).sum(-1))


def _cos_sin(angle: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    a = angle.astype(np.float64)
    return np.cos(a).astype(_F32), np.sin(a).astype(_F32)


def _sample_attributes(key, cfg):
    """Human (v_pref, radius): U(0.5, 1.5) and U(0.3, 0.5) when
    ``randomize_attributes``, else the configured constants. [B] each."""
    if cfg.randomize_attributes:
        k = split(key, 2)
        return uniform(k[..., 0, :], 0.5, 1.5), uniform(k[..., 1, :], 0.3,
                                                        0.5)
    shape = key.shape[:-1]
    return (np.full(shape, cfg.human_v_pref, _F32),
            np.full(shape, cfg.human_radius, _F32))


def _accept(pos, radius, occ_pos, occ_rad, occ_valid, cfg):
    """pos [B, A, 2] attempts against the occupied starts [B, M, 2]:
    accepted where every valid one is farther than the radii plus the
    discomfort distance. -> [B, A] bool."""
    d = _norm(occ_pos[:, None, :, :] - pos[:, :, None, :])  # [B, A, M]
    min_dist = (radius[:, None, None] + occ_rad[:, None, :]
                + _F32(cfg.reward.discomfort_dist))
    return np.where(occ_valid[:, None, :], d > min_dist, True).all(-1)


def _first_ok(cands: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """The first accepted attempt of each case, else the last one."""
    idx = np.where(ok.any(-1), ok.argmax(-1), _ATTEMPTS - 1)
    return cands[np.arange(cands.shape[0]), idx]


def _circle_crossing_human(key, cfg, occ_pos, occ_rad, occ_valid):
    k = split(key, 2)
    v_pref, radius = _sample_attributes(k[:, 0], cfg)
    tries = split(k[:, 1], _ATTEMPTS)  # [B, A, 2]
    ka, kx, ky = np.moveaxis(split(tries, 3), -2, 0)
    angle = uniform(ka, 0.0, 2.0 * np.pi)
    nx = (uniform(kx) - _F32(0.5)) * v_pref[:, None]
    ny = (uniform(ky) - _F32(0.5)) * v_pref[:, None]
    cos, sin = _cos_sin(angle)
    r = _F32(cfg.sim.circle_radius)
    pos = np.stack([r * cos + nx, r * sin + ny], axis=-1)
    ok = _accept(pos, radius, occ_pos, occ_rad, occ_valid, cfg)
    pos = _first_ok(pos, ok)
    return pos, -pos, v_pref, radius


def _square_crossing_human(key, cfg, occ_pos, occ_rad, occ_valid):
    k_attr, k_sgn, k_pos, k_goal = np.moveaxis(split(key, 4), -2, 0)
    v_pref, radius = _sample_attributes(k_attr, cfg)
    sign = np.where(uniform(k_sgn) > _F32(0.5), _F32(1.0), _F32(-1.0))
    w = _F32(cfg.sim.square_width)

    def try_place(k, sgn):
        kx, ky = np.moveaxis(split(split(k, _ATTEMPTS), 2), -2, 0)
        px = uniform(kx) * w * _F32(0.5) * sgn[:, None]
        py = (uniform(ky) - _F32(0.5)) * w
        pos = np.stack([px, py], axis=-1)
        return _first_ok(pos, _accept(pos, radius, occ_pos, occ_rad,
                                      occ_valid, cfg))

    return try_place(k_pos, sign), try_place(k_goal, -sign), v_pref, radius


def generate_cases(keys: np.ndarray, cfg
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Scenarios of the case keys [B, 2] -> (robot FullState [B, 9], humans
    FullState [B, N, 9]), float32.

    The robot starts at (0, -circle_radius) facing its goal (0,
    circle_radius); humans are placed one after another, each avoiding the
    robot and every human placed before it.
    """
    keys = np.asarray(keys, np.uint32)
    B, n, r = keys.shape[0], cfg.sim.human_num, cfg.sim.circle_radius
    robot = np.broadcast_to(np.array(
        [0.0, -r, 0.0, 0.0, cfg.robot_radius, 0.0, r, cfg.robot_v_pref,
         np.pi / 2], _F32), (B, 9)).copy()
    occ_pos = np.zeros((B, n + 1, 2), _F32)
    occ_pos[:, 0] = robot[:, :2]
    occ_rad = np.zeros((B, n + 1), _F32)
    occ_rad[:, 0] = cfg.robot_radius
    occ_valid = np.zeros((B, n + 1), bool)
    occ_valid[:, 0] = True
    place = (_circle_crossing_human if cfg.sim.scenario == "circle_crossing"
             else _square_crossing_human)
    humans = np.zeros((B, n, 9), _F32)
    human_keys = split(keys, n)
    for i in range(n):
        pos, goal, v_pref, radius = place(human_keys[:, i], cfg, occ_pos,
                                          occ_rad, occ_valid)
        humans[:, i, PX:PY + 1] = pos
        humans[:, i, RADIUS] = radius
        humans[:, i, GX:GY + 1] = goal
        humans[:, i, VPREF] = v_pref
        occ_pos[:, i + 1] = pos
        occ_rad[:, i + 1] = radius
        occ_valid[:, i + 1] = True
    return robot, humans
