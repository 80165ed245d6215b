"""The least work of one decode step of a GraniteMoeHybrid stage at batch B.

Counted from the configuration's published keys (``bench/configs``), the
batch and the step's cache length alone: no kernel or layout of the
program enters.  Bytes are those any evaluation has to move through
device memory once, at the precisions the configuration states; FLOPs
count a multiply-add as 2.

Bytes of a step:
- every weight of the stage once, in bfloat16 (the router in float32):
  at B·k = 1280 (token, expert) pairs over 72 experts an expert is idle
  with probability (1 − k/E)^B ≈ 5e-9, so every routed expert is read;
  the tied embedding once, as the head;
- the Mamba state h (H, d_head, d_state), in float32, and the conv
  window (K − 1, C), in bfloat16, of every sequence and SSD layer, read
  and written;
- the keys and values of every sequence's cache, the positions before the
  step read and the step's own row written, in bfloat16;
- the logits written once, in float32.

FLOPs of a step (per sequence, times B): the projections of each layer,
the conv, the SSD state update (decay, outer product, add) and its read
out, the attention's scores and sum over the cache, the router, k routed
experts and the shared expert, and the head.

The least time is the larger of bytes ÷ 3.35 TB/s (``costs.
PEAK_BYTES_PER_S``) and FLOPs ÷ the dense bfloat16 peak below.
"""
from __future__ import annotations

from costs import PEAK_BYTES_PER_S

#: NVIDIA H100 SXM, dense bfloat16 on the tensor cores (data sheet)
PEAK_BF16_FLOPS_PER_S = 989e12
BF16, F32 = 2, 4


def _dims(config: dict) -> dict:
    d = config["hidden_size"]
    d_in = config["mamba_expand"] * d
    n = config["mamba_d_state"]
    H = config["mamba_n_heads"]
    Hq, KV = config["num_attention_heads"], config["num_key_value_heads"]
    return dict(d=d, d_in=d_in, n=n, H=H, hd=config["mamba_d_head"],
                K=config["mamba_d_conv"], C=d_in + 2 * n, Hq=Hq, KV=KV,
                ad=d // Hq, E=config["num_local_experts"],
                k=config["num_experts_per_tok"],
                f=config["intermediate_size"],
                fs=config["shared_intermediate_size"],
                V=config["vocab_size"])


def layers(config: dict) -> tuple:
    """(SSD layers, attention layers) of the stage: the first
    ``num_hidden_layers`` of ``layer_types``."""
    kinds = config["layer_types"][: config["num_hidden_layers"]]
    return kinds.count("mamba"), kinds.count("attention")


def step(config: dict, batch: int, kv_len: float) -> dict:
    """{"bytes", "flops", "seconds"} of one decode step of ``batch``
    sequences whose caches hold ``kv_len`` positions (the mean over the
    batch) before the step."""
    g = _dims(config)
    d, B = g["d"], batch
    n_ssm, n_attn = layers(config)
    n_layers = n_ssm + n_attn
    # weights, element counts
    in_proj = d * (2 * g["d_in"] + 2 * g["n"] + g["H"])
    w_ssm = (in_proj + g["C"] * (g["K"] + 1) + g["d_in"] + g["d_in"] * d
             + d)
    w_attn = 2 * d * g["Hq"] * g["ad"] + 2 * d * g["KV"] * g["ad"] + d
    w_ffn = 3 * d * (g["E"] * g["f"] + g["fs"]) + d
    weights = BF16 * (n_ssm * w_ssm + n_attn * w_attn + n_layers * w_ffn
                      + g["V"] * d + d)
    weights += F32 * n_layers * (d * g["E"]) + F32 * n_ssm * 3 * g["H"]
    state = n_ssm * B * 2 * (F32 * g["H"] * g["hd"] * g["n"]
                             + BF16 * (g["K"] - 1) * g["C"])
    row = g["KV"] * g["ad"] * 2                 # one position's K and V
    kv = n_attn * B * BF16 * row * (kv_len + 1)
    logits = B * g["V"] * F32
    nbytes = weights + state + kv + logits
    # FLOPs a sequence
    f_ssm = (2 * in_proj + 2 * g["K"] * g["C"] + 2 * g["d_in"] * d
             + 5 * g["H"] * g["hd"] * g["n"])
    f_attn = (4 * d * g["Hq"] * g["ad"] + 4 * d * g["KV"] * g["ad"]
              + 4 * g["Hq"] * g["ad"] * (kv_len + 1))
    f_ffn = 2 * d * g["E"] + 6 * d * (g["k"] * g["f"] + g["fs"])
    flops = B * (n_ssm * f_ssm + n_attn * f_attn + n_layers * f_ffn
                 + 2 * d * g["V"])
    seconds = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS_PER_S)
    return {"bytes": nbytes, "flops": flops, "seconds": seconds}
