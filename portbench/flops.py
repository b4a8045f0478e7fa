"""Operations, bytes, peaks and the roofline bound, frozen here.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 989
TFLOP/s for bf16 operands on the tensor cores, 495 TFLOP/s for f32
operands (TF32 on the tensor cores: the fastest an implementation of
f32 operands could go), 3.35 TB/s of HBM. A kernel's bound is the larger
of its operations over the peak of its operands' precision and its
bytes (each input read once, each output written once) over the HBM
rate. Model FLOPs count a product of an (m, k) by a (k, n) matrix as
2mkn and nothing recomputed.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

PEAK_BF16 = 989e12
PEAK_F32 = 495e12
HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float) -> Tuple[float, str]:
    """(the least seconds, "operations" or "bytes": the term that bounds)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def peak_of(*elsizes: int) -> float:
    """The tensor-core peak of operands of these element sizes: f32 if
    any operand is 4 bytes wide, else bf16."""
    return PEAK_F32 if max(elsizes) >= 4 else PEAK_BF16


def k1(b: int, s: int, hq: int, hkv: int, hd: int, elsize: int) -> Tuple[float, float, float]:
    """Causal flash attention over a (padded) length s: QKᵀ and PV over
    the s(s+1)/2 visible pairs of each q head; q, k, v read and o written
    once. Returns (flops, bytes, peak)."""
    pairs = s * (s + 1) / 2
    flops = 4.0 * b * hq * hd * pairs
    nbytes = elsize * b * s * hd * (2 * hq + 2 * hkv)
    return flops, nbytes, peak_of(elsize)


def k2(b: int, hq: int, hkv: int, hd: int, fills: Sequence[int], q_elsize: int,
       cache_elsize: int) -> Tuple[float, float, float]:
    """One-token attention of b rows against their caches, each read only
    up to its fill (cache_len, the token written this step included)."""
    rows = float(sum(fills))
    flops = 4.0 * hq * hd * rows
    nbytes = 2 * cache_elsize * hkv * hd * rows + q_elsize * b * hq * hd \
        + cache_elsize * b * hq * hd
    return flops, nbytes, peak_of(q_elsize, cache_elsize)


def k3(b: int, s: int, h: int, p: int, n: int, x_elsize: int,
       bc_elsize: int) -> Tuple[float, float, float]:
    """The SSD scan: the recurrence's state update and read, 4PN a token
    and head; x, dt (f32), A, B, C read once, y (f32) and the final state
    (f32) written once."""
    flops = 4.0 * b * s * h * p * n
    nbytes = (x_elsize * b * s * h * p + 4 * b * s * h + 4 * h
              + 2 * bc_elsize * b * s * n + 4 * b * s * h * p + 4 * b * h * p * n)
    return flops, nbytes, peak_of(x_elsize, bc_elsize)


def k4_quantize(n: int, x_elsize: int = 4, block: int = 256) -> Tuple[float, float, float]:
    """Blockwise int8: n values read, n int8 and a f32 scale a block
    written; an absolute value, a max and a division a value."""
    nblk = -(-n // block)
    return 3.0 * n, x_elsize * n + n + 4 * nblk, PEAK_F32


def k4_dequantize(n: int, out_elsize: int = 4, block: int = 256) -> Tuple[float, float, float]:
    nblk = -(-n // block)
    return 1.0 * n, n + 4 * nblk + out_elsize * n, PEAK_F32


# ----------------------------------------------------------------------
# model FLOPs
# ----------------------------------------------------------------------

def layer_matmul_params(m: Dict) -> int:
    """Weights of one layer that enter a matrix product."""
    d = m["d_model"]
    if m["family"] == "ssm":
        di = m["ssm_expand"] * d
        nh = di // m["ssm_head_dim"]
        return d * (2 * di + 2 * m["ssm_state"] + nh) + di * d
    hq, hkv, hd, f = m["num_heads"], m["num_kv_heads"], m["head_dim"], m["d_ff"]
    return d * hd * (2 * hq + 2 * hkv) + 3 * d * f


def head_params(m: Dict) -> int:
    return m["vocab_size"] * m["d_model"]


def mixer_flops(m: Dict, fills: Sequence[int]) -> float:
    """The sequence mixing of tokens at these fills (the positions they
    see, themselves included), all layers: attention 4·hd per visible
    pair and q head; the SSD 4PN per head; the SSM conv 2K per channel."""
    L = m["num_layers"]
    if m["family"] == "ssm":
        d = m["d_model"]
        di = m["ssm_expand"] * d
        per_tok = 4.0 * di * m["ssm_state"] + 2.0 * m["ssm_conv"] * (di + 2 * m["ssm_state"])
        return L * per_tok * len(fills)
    return L * 4.0 * m["num_heads"] * m["head_dim"] * float(sum(fills))


def prefill_flops(m: Dict, n: int) -> float:
    """A prompt of n tokens (unpadded): every layer on every token, the
    head on the last one."""
    body = 2.0 * layer_matmul_params(m) * m["num_layers"] * n
    return body + 2.0 * head_params(m) + mixer_flops(m, range(1, n + 1))


def decode_flops(m: Dict, fills: Sequence[int]) -> float:
    """One decode step of len(fills) live rows, each at its fill."""
    per_tok = 2.0 * (layer_matmul_params(m) * m["num_layers"] + head_params(m))
    return per_tok * len(fills) + mixer_flops(m, fills)


def train_step_flops(m: Dict, batch: int, seq: int) -> float:
    """Forward and backward (3x the forward) of batch x seq tokens, the
    head on every token, causal attention over each sequence."""
    fwd = 2.0 * (layer_matmul_params(m) * m["num_layers"] + head_params(m)) * batch * seq
    fwd += batch * mixer_flops(m, range(1, seq + 1))
    return 3.0 * fwd
