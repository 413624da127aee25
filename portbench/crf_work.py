"""Bytes of the Viterbi decode's kernels K2a, K2b and K2c from shapes, and
the least time they could take on the card.

The decode is bound by bytes: its arithmetic is ~100 f32 operations a
state and step (at 1024 states, T=2000 and N=256, ~52 G operations: under
1 ms at 67 TFLOP/s outside the tensor cores), while every score is read
twice.  Each input byte is counted read once and each output byte written
once, whatever a kernel reads again (``portbench/work.py``'s rule).  With
C = n_state (n_base + 1) scores a frame, f32 scores, betas and v_final,
uint8 backpointers and int8 labels:

* K2a (the backward scan) reads the scores, 4 T N C, and writes the betas
  beta_0 .. beta_T, 4 (T + 1) N n_state;
* K2b (the forward scan fused with Viterbi) reads the scores, the betas
  beta_1 .. beta_T it adds, 4 T N n_state, and logZ, 4 N; it writes the
  backpointers, T N n_state, and v_final, 4 N n_state;
* K2c (the traceback) reads v_final and one backpointer a step of each
  walk, T N, and writes the labels, T N.

At NACGT and state_len 5 (1024 states x 5), T=2000 and N=256: K2a 12.58
GB, K2b 13.11 GB, K2c 2.1 MB; 7.67 ms at 3.35 TB/s.
"""

from __future__ import annotations

from portbench.work import PEAK_BYTES


def k2_bytes(T: int, N: int, n_base: int, n_state: int) -> dict:
    """{"k2a", "k2b", "k2c": bytes} of one decode of N rows of T frames."""
    C = n_state * (n_base + 1)
    scores = 4.0 * T * N * C
    v_final = 4.0 * N * n_state
    return {
        "k2a": scores + 4.0 * (T + 1) * N * n_state,
        "k2b": scores + 4.0 * T * N * n_state + 4.0 * N
        + 1.0 * T * N * n_state + v_final,
        "k2c": v_final + 2.0 * T * N,
    }


def k2_bound_s(T: int, N: int, n_base: int, n_state: int) -> float:
    """The least time of one decode's three kernels: their bytes over the
    card's 3.35 TB/s."""
    return sum(k2_bytes(T, N, n_base, n_state).values()) / PEAK_BYTES
