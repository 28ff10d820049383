"""The floor of Point Transformer V3's attention: for each sequence of
L points at width C (every head together), the larger of its FLOPs,
4·L²·C (q kᵀ and the weighted sum), at the card's bf16 peak and its
bytes, q, k, v and the output once each in bf16 (8·L·C), at its HBM
rate; summed over every block that attends over the level's
sequences, the encoder's at its width and the decoder's at its own.
The sequences are what PTv3 defines (`sequences` of the backbone), each
padded patch at its K."""

from __future__ import annotations

from typing import Dict, Sequence

from posebench.metrics.flops import BF16_PEAK_FLOPS, HBM_BYTES_PER_S

# the fused-attention kernels as a trace names them: flash-attention's,
# the memory-efficient (CUTLASS) kernels' and cuDNN's
ATTN_SYMBOLS = ("flash_fwd", "fmha", "attention_kernel", "sdpa")


def sequence_floor_us(L: int, C: int) -> float:
    return 1e6 * max(4.0 * L * L * C / BF16_PEAK_FLOPS,
                     8.0 * L * C / HBM_BYTES_PER_S)


def attention_floor_us(widths: Dict, sequences: Sequence[Sequence[int]]
                       ) -> float:
    """The floor of one forward's attention, from each level's sequence
    lengths."""
    enc = widths["enc_channels"]
    outs = list(widths["dec_channels"])
    total = 0.0
    for l, seqs in enumerate(sequences):
        for L in seqs:
            total += widths["enc_depths"][l] * sequence_floor_us(L, enc[l])
            if l < len(outs):
                total += (widths["dec_depths"][l]
                          * sequence_floor_us(L, outs[l]))
    return total
