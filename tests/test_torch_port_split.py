"""The exact operand splits of the port's tensor-core kernels
(``raft_tpu_torch/csrc/tensor_core.cuh``), emulated in plain PyTorch here,
on the CPU: 3xTF32 for float32 x float32 products (the GRU's float32 entry,
the float32 correlation lookup) and three bfloat16 pieces for a float32
activation against a bfloat16 weight (the GRU's bfloat16 entry).  The
kernels themselves run only on the card (``chip_smoke.py``); these tests
pin the arithmetic they rely on."""

import math

import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import gru_cuda

torch.set_num_threads(2)   # several test workers share the host's cores


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to tf32 as the kernels do: add half of the 13 dropped
    bits to the magnitude, then clear them (nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def split_bf16x3(x):
    hi = x.bfloat16().float()
    r = x - hi
    mid = r.bfloat16().float()
    return hi, mid, (r - mid).bfloat16().float()


def _values(kind: str, n: int = 4096) -> torch.Tensor:
    rng = np.random.RandomState({"normal": 0, "tiny": 1, "negative": 2}[kind])
    sign = np.where(rng.rand(n) < 0.5, -1.0, 1.0)
    x = sign * rng.uniform(1, 2, n) * np.exp(rng.uniform(-20, 20, n))
    if kind == "tiny":     # near 1e-30: the pieces, 2^-16 below, stay normal
        x = sign * rng.uniform(1, 2, n) * np.exp(rng.uniform(-3, 3, n)) * 1e-30
    if kind == "negative":
        x = -np.abs(x)
    return torch.from_numpy(x.astype(np.float32))


def test_tf32_rounding_is_nearest_ties_away_and_matches_the_package():
    x = torch.cat([_values("normal"), _values("negative")])
    # exact ties: the dropped 13 bits are 0x1000
    ties = (torch.arange(1, 65, dtype=torch.int32) << 13 | 0x1000
            | (127 << 23)).view(torch.float32)
    x = torch.cat([x, ties, -ties])
    hi = tf32(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    # against float64: the nearest multiple of the tf32 ulp, ties away
    xd = x.double()
    ulp = torch.ldexp(torch.ones_like(xd), torch.frexp(xd).exponent - 11)
    want = torch.sign(xd) * torch.floor(xd.abs() / ulp + 0.5) * ulp
    assert torch.equal(hi.double(), want)
    # the package's weight split (prepare_gru_weights) rounds the same way
    assert torch.equal(gru_cuda._tf32(x), hi)
    hi_, lo = split_tf32(x)
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    err = ((hi_.double() + lo.double()) - xd).abs()
    assert bool((err <= 2.0 ** -22 * xd.abs()).all())


@pytest.mark.parametrize("kind", ["normal", "tiny", "negative"])
def test_three_bf16_pieces_reconstruct_float32(kind):
    x = _values(kind)
    hi, mid, lo = split_bf16x3(x)
    for p in (hi, mid, lo):                  # each piece is a bfloat16
        assert torch.equal(p.bfloat16().float(), p)
    err = ((hi.double() + mid.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -24 * x.double().abs()).all())


def test_piece_products_are_exact_in_float32():
    x = _values("normal")
    w = torch.from_numpy(np.random.RandomState(3).randn(x.numel()).astype(
        np.float32)).bfloat16().float()              # a bfloat16-exact weight
    for p in split_bf16x3(x):
        assert torch.equal((p * w).double(), p.double() * w.double())
    a_hi, a_lo = split_tf32(x)
    b_hi, b_lo = split_tf32(torch.from_numpy(
        np.random.RandomState(4).randn(x.numel()).astype(np.float32)))
    for a, b in ((a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi)):
        assert torch.equal((a * b).double(), a.double() * b.double())


def _gru_operands(k: int, seed: int):
    """h from tanh, motion ReLU'd, and weights at init_raft_torch's Kaiming
    fan-out scale of a 1x5 gate conv at hidden = motion = 128."""
    rng = np.random.RandomState(seed)
    act = np.concatenate([np.tanh(rng.randn(k // 2)),
                          np.maximum(rng.randn(k // 2), 0.0)])
    w = rng.randn(k) * math.sqrt(2.0 / (5 * 128))
    return (torch.from_numpy(act.astype(np.float32)),
            torch.from_numpy(w.astype(np.float32)))


def _blocked_sum(products: torch.Tensor, block: int) -> torch.Tensor:
    """The kernels' order: each k-block summed in FP32 on its own, then
    added to an FP32 register sum."""
    acc = torch.zeros((), dtype=torch.float32)
    for b in products.split(block):
        acc = acc + b.sum()
    return acc


@pytest.mark.parametrize("case", ["gru_f32", "gru_bf16_entry", "corr_f32"])
def test_split_dot_products_stay_within_1e6_of_float64(case):
    worst = 0.0
    for seed in range(4):
        if case == "corr_f32":                       # K = 256, scaled by 1/16
            rng = np.random.RandomState(10 + seed)
            a, b = (torch.from_numpy(rng.randn(256).astype(np.float32))
                    for _ in range(2))
            scale, block = 1.0 / 16.0, 32
        else:                                        # K = 5 taps x 256 = 1280
            a, b = _gru_operands(1280, seed)
            scale, block = 1.0, 40
        if case == "gru_bf16_entry":                 # f32 activation, bf16 weight
            b = b.bfloat16().float()
            terms = [p * b for p in split_bf16x3(a)[::-1]]
            block = 80
        else:
            (a_hi, a_lo), (b_hi, b_lo) = split_tf32(a), split_tf32(b)
            terms = [a_lo * b_hi, a_hi * b_lo, a_hi * b_hi]
        got = _blocked_sum(torch.stack(terms, dim=1).reshape(-1), 3 * block) * scale
        want = float((a.double() * b.double()).sum()) * scale
        worst = max(worst, abs(float(got) - want))
    assert worst <= 1e-6, worst
