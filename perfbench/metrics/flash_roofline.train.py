"""``flash_roofline.train``: the training step's flash attention kernels,
forward and backward, as a share (%) of their roofline.

The least time of each layer's attention, forward and backward apart, is
the larger of its FLOPs over the peak of the compute type and its bytes
over HBM's bandwidth; the window's sum of those over the device time of the
kernels whose names match ``PATTERN``.  Counted is the work the model
needs: forward 4 FLOPs per causal pair and head dimension, backward twice
that (four products against two); forward reads q, k, v once and writes o
and the row statistics (f32) once; backward reads q, k, v, o, the output's
gradient and the statistics once and writes dq, dk, dv once.
"""

PATTERN = r"flash_(fwd|bwd)"


def layer_bound_s(cfg, rows: int, seq: int, itemsize: int, peak_flops: float,
                  bandwidth: float) -> float:
    E = cfg["n_embd"]
    pairs = seq * (seq + 1) // 2
    fwd_flops = 4.0 * rows * E * pairs
    tensor = rows * seq * E * itemsize           # one of q, k, v, o
    stats = rows * seq * cfg["n_head"] * 4       # log-sum-exp, f32
    fwd_bytes = 4 * tensor + stats
    bwd_bytes = 8 * tensor + stats
    return (max(fwd_flops / peak_flops, fwd_bytes / bandwidth)
            + max(2 * fwd_flops / peak_flops, bwd_bytes / bandwidth))


def read(run):
    f = run.facts
    if f.get("kind") != "train" or run.trace is None:
        return None
    spent = run.trace.seconds_matching(PATTERN)
    if spent <= 0:
        return None
    dtype = run.traffic["compute_dtype"]
    itemsize = 2 if dtype in ("bfloat16", "float16") else 4
    bound = layer_bound_s(run.config, f["rows"], f["seq_len"], itemsize,
                          run.peaks["flops_per_s"][dtype],
                          run.peaks["hbm_bytes_per_s"])
    return 100.0 * bound * run.config["n_layer"] * f["steps"] / spent
