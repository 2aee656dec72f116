"""The nearest-code search's share of its roofline.

Work, whatever implements it: 2 * N * K * D operations for N latent rows
against K codes of depth D; bytes: z (N x D fp32), the codebook (K x D fp32)
once a call and the int32 indices, each read or written once. The least
time is the larger of operations over the peak of the mode's arithmetic and
bytes over the memory's bandwidth. The time is the device time of every
kernel that can serve the search: the hand-written kernels by name
(``spec["kernels"]``) and the matmul branch's products, NaN pass and argmin
(``spec["branch_ops"]`` launched inside ``spec["inside"]``).
"""


def read(view, info, spec):
    kernels, branch, inside = spec["kernels"], set(spec["branch_ops"]), spec["inside"]

    def search(op):
        if op.cat != "kernel":
            return False
        if any(k in op.name for k in kernels):
            return True
        return inside in op.ancestors and bool(op.ancestors) and op.ancestors[-1] in branch

    sec = view.seconds(search)
    if sec == 0.0 or not info.items or not info.peaks or not info.rows_per_item:
        return None
    k, d = info.sizes["n_embeddings"], info.sizes["embedding_dim"]
    n = info.items * info.rows_per_item
    ops = 2.0 * n * k * d
    nbytes = 4.0 * n * d + 4.0 * k * d * info.steps + 4.0 * n
    arith = "float32" if info.sizes["quantizer_precision"] == "highest" else "bfloat16"
    least = max(ops / info.peaks["flops"][arith], nbytes / info.peaks["hbm_bytes_per_s"])
    return 100.0 * least / sec
