"""``train_mfu``: the whole training step's model FLOPs per second, as a
share (%) of the card's peak in the type the products run in.

Model FLOPs of one step, recomputation not counted: forward and backward
of every matrix product, 6 per parameter that takes part in one and per
token (each block's query/key/value, output and two MLP projections, and
``lm_head``; the embeddings are lookups), and attention's two products
over the causal pairs, 4 FLOPs per pair and head dimension forward and
twice that backward.  The time is the device's: from the start of the
traced window's first device operation to the end of its last (the
trace's ``span_s``), over the window's steps, all of which run in it.
"""


def matmul_params(cfg) -> int:
    E, V = cfg["n_embd"], cfg["vocab_size"]
    F = cfg.get("n_inner") or 4 * E
    return cfg["n_layer"] * (4 * E * E + 2 * E * F) + E * V


def attention_pair_flops(cfg, rows: int, seq: int) -> float:
    """Forward FLOPs of attention's two products over the causal pairs of
    ``rows`` sequences of ``seq`` tokens, all layers."""
    pairs = seq * (seq + 1) // 2
    return 4.0 * rows * cfg["n_embd"] * pairs * cfg["n_layer"]


def step_flops(cfg, rows: int, seq: int) -> float:
    return (6.0 * matmul_params(cfg) * rows * seq
            + 3.0 * attention_pair_flops(cfg, rows, seq))


def read(run):
    f = run.facts
    if (f.get("kind") != "train" or not f["steps"] or run.trace is None
            or run.trace.span_s <= 0):
        return None
    peak = run.peaks["flops_per_s"][run.traffic["compute_dtype"]]
    flops = step_flops(run.config, f["rows"], f["seq_len"]) * f["steps"]
    return 100.0 * flops / run.trace.span_s / peak
