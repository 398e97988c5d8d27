"""The kernel-RNG noise stream, plain PyTorch version.

The capacity ("nothing-in-HBM") mode draws its exploration noise inside
the CUDA kernels (``csrc/rollout_kernels.cu``: ``stream_normals`` and
``StreamNoise``) instead of reading a (T, K, C) array; this module is the
same stream in PyTorch, which the plain versions of both passes and the
tests use.  It replaces the TPU's per-core PRNG (``_kernel_normals``,
``autorally_tpu/ops/rollout_kernel.py:1201``), whose bits cannot be
reproduced off the TPU; the stream is equal to it in distribution.

- **Key:** two uint32 values in an int64 tensor (2,): the subkey that
  :func:`split` takes from the controller state's key once per iteration,
  as the JAX package's ``_solve`` does (:func:`prng_key` makes a seed's
  key).  The kernels read it through a device pointer.
- **Counter:** (global rollout index ``k_offset + k``, timestep t), through
  Threefry-2x32-20 (Random123).  The stream therefore does not depend on
  the launch's block layout (pass 2 replays pass 1 exactly), and shards
  that pass their ``k_offset`` draw disjoint streams.
- **Uniforms:** each 32-bit output becomes a 23-bit uniform, ``raw >> 9``
  times 2^-23, as ``_kernel_normals`` does; ``u1 += 1e-7`` keeps log(u1)
  finite.
- **Normals:** one Box-Muller pair, (r cos 2 pi u2, r sin 2 pi u2) with
  r = sqrt(-2 log u1), gives (eps_0, eps_1).
- **OU:** x_0 = w_0, x_t = a x_{t-1} + b w_t
  (:func:`autorally_tpu_torch.ops.sampling.ou_recursion`).

Every float operation is a single IEEE-rounded float32 add, multiply,
divide or square root, and the logarithm and sine/cosine are evaluated
here from those operations (:func:`stream_log`, :func:`stream_sincos_2pi`)
rather than with a math library: the CUDA kernels evaluate the same
sequence with ``__fadd_rn``/``__fmul_rn``/``__fdiv_rn``/``__fsqrt_rn``, so
this version reproduces the kernels' noise bit for bit on any device.
The polynomials are Taylor series accurate to about 1e-7 relative.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from autorally_tpu_torch.ops.sampling import ou_recursion

_MASK = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_KS_PARITY = 0x1BD11BDA

# float32 constants of the stream, by their names in csrc/rollout_kernels.cu
# (which spells them as hex-float literals; tests hold the two equal).
CONSTANTS = {
    "kTwoM23": 2.0 ** -23,
    "kU1Guard": 1e-7,
    "kSqrtHalf": 0.5 ** 0.5,
    "kLn2": float(np.log(2.0)),
    "kTwoPi": 2.0 * np.pi,
    # 2 atanh(s) = 2 s + s z (2/3 + z (2/5 + ... + z 2/13)), z = s^2
    **{f"kLog{n}": 2.0 / n for n in (3, 5, 7, 9, 11, 13)},
    "kSin3": -1.0 / 6, "kSin5": 1.0 / 120, "kSin7": -1.0 / 5040,
    "kSin9": 1.0 / 362880,
    "kCos2": -0.5, "kCos4": 1.0 / 24, "kCos6": -1.0 / 720,
    "kCos8": 1.0 / 40320, "kCos10": -1.0 / 3628800,
}
CONSTANTS = {k: float(np.float32(v)) for k, v in CONSTANTS.items()}
_C = CONSTANTS


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, counter) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (Random123) on int64 tensors holding
    uint32 values: ``key`` = (k0, k1), ``counter`` = (c0, c1), broadcast
    against each other; every sum is masked back to 32 bits.  Returns the
    two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (counter[0] + ks[0]) & _MASK
    x1 = (counter[1] + ks[1]) & _MASK
    for i in range(20):
        x0 = (x0 + x1) & _MASK
        x1 = _rotl(x1, _ROTATIONS[i % 8]) ^ x0
        if i % 4 == 3:                     # key injection s = 1 .. 5
            s = i // 4 + 1
            x0 = (x0 + ks[s % 3]) & _MASK
            x1 = (x1 + ks[(s + 1) % 3] + s) & _MASK
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """The key of ``seed``, two uint32 words equal to the JAX package's
    ``jax.random.key_data(jax.random.PRNGKey(seed))`` (Threefry, 32-bit
    mode): ``[0, seed mod 2^32]`` for any int64 seed."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit in int64")
    return np.array([0, seed & _MASK], dtype=np.uint32)


def split(key) -> Tuple[np.ndarray, np.ndarray]:
    """``jax.random.split(key)`` of a key of two uint32 words, bit for bit:
    (new key, subkey), each (2,) uint32.  This is JAX's default
    (``jax_threefry_partitionable``) fold-like split, Threefry-2x32 of the
    key over the counters (0, 0) and (0, 1); Python integers on the host,
    so a solve that splits its key waits for nothing on the device."""
    k0, k1 = (int(w) & _MASK for w in key)
    new = threefry2x32((k0, k1), (0, 0))
    sub = threefry2x32((k0, k1), (0, 1))
    return np.array(new, np.uint32), np.array(sub, np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` of a key of two uint32 words, bit
    for bit: Threefry-2x32 of the key over the counter (0, data), on host
    integers.  A shard folds its index into the iteration's subkey, so that
    every shard draws its own stream (``parallel/sharded.py``)."""
    k0, k1 = (int(w) & _MASK for w in key)
    return np.array(threefry2x32((k0, k1), (0, int(data) & _MASK)),
                    np.uint32)


def stream_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of float32 ``x`` in (0, 1]: x = m 2^e with m in
    [sqrt(1/2), sqrt(2)), log m = 2 atanh((m - 1) / (m + 1))."""
    bits = x.view(torch.int32)
    e = (bits >> 23) - 126
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    small = m < _C["kSqrtHalf"]
    m = torch.where(small, m * 2.0, m)
    e = torch.where(small, e - 1, e)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    p = torch.full_like(z, _C["kLog13"])
    for n in (11, 9, 7, 5, 3):
        p = p * z + _C[f"kLog{n}"]
    log_m = s * 2.0 + (s * z) * p
    return e.to(torch.float32) * _C["kLn2"] + log_m


def stream_sincos_2pi(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of 2 pi m 2^-23 for integers 0 <= m < 2^23 (int64): the
    top two bits pick the quadrant, the rest, reduced to [-1/8, 1/8) of a
    turn, is exact in float32 and feeds two short Taylor series."""
    q = m >> 21
    f = (m & 0x1FFFFF).to(torch.float32) * _C["kTwoM23"]         # [0, 1/4)
    hi = f >= 0.125
    f = torch.where(hi, f - 0.25, f)
    q = torch.where(hi, q + 1, q) & 3
    x = f * _C["kTwoPi"]
    z = x * x
    ps = torch.full_like(z, _C["kSin9"])
    for n in (7, 5, 3):
        ps = ps * z + _C[f"kSin{n}"]
    s = x + (x * z) * ps
    pc = torch.full_like(z, _C["kCos10"])
    for n in (8, 6, 4, 2):
        pc = pc * z + _C[f"kCos{n}"]
    c = z * pc + 1.0
    # rotate by q quarter turns: (c, s) -> (-s, c) per turn
    cos = torch.where(q == 0, c, torch.where(q == 1, -s,
                                             torch.where(q == 2, -c, s)))
    sin = torch.where(q == 0, s, torch.where(q == 1, c,
                                             torch.where(q == 2, -s, -c)))
    return cos, sin


def normals_from_bits(r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """Box-Muller of two 32-bit words (int64 tensors) into a standard
    normal pair, stacked on a new last axis."""
    u1 = (r0 >> 9).to(torch.float32) * _C["kTwoM23"] + _C["kU1Guard"]
    # PyTorch's float32 sqrt on the CPU is not always correctly rounded;
    # the float64 root rounded to float32 is (as the kernels' __fsqrt_rn)
    r = torch.sqrt((stream_log(u1) * -2.0).double()).float()
    cos, sin = stream_sincos_2pi(r1 >> 9)
    return torch.stack([r * cos, r * sin], dim=-1)


def kernel_normals(key: torch.Tensor, k_offset: int, K: int,
                   T: int) -> torch.Tensor:
    """White standard normals (T, K, 2) of rollouts ``k_offset`` ..
    ``k_offset + K - 1`` on ``key``'s device."""
    if key.dtype != torch.int64 or key.shape != (2,):
        raise ValueError(f"key must be an int64 tensor of shape (2,), got "
                         f"{key.dtype} {tuple(key.shape)}")
    dev = key.device
    k = (torch.arange(K, dtype=torch.int64, device=dev)
         + int(k_offset)) & _MASK
    t = torch.arange(T, dtype=torch.int64, device=dev)
    r0, r1 = threefry2x32((key[0], key[1]), (k[None, :], t[:, None]))
    return normals_from_bits(r0, r1)


def kernel_noise(key: torch.Tensor, k_offset: int, K: int, T: int,
                 theta: Optional[float] = None) -> torch.Tensor:
    """The stream the kernels draw (T, K, 2): white normals, or with
    ``theta`` the OU recursion run over them."""
    w = kernel_normals(key, k_offset, K, T)
    return w if theta is None else ou_recursion(w, theta)
