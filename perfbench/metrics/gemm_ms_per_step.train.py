"""``gemm_ms_per_step.train``: device milliseconds of matrix-product
kernels (cuBLAS's and CUTLASS's, by the names in ``PATTERN``) per training
step in the traced window."""

PATTERN = r"(?i)gemm|nvjet|xmma|cutlass"


def read(run):
    f = run.facts
    if f.get("kind") != "train" or run.trace is None or not f["steps"]:
        return None
    spent = run.trace.seconds_matching(PATTERN)
    if spent <= 0:
        return None
    return 1e3 * spent / f["steps"]
