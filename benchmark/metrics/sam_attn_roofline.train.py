"""The rel-pos attention kernel's share of its roofline (%): the least time
of its calls in the SAM encoder (benchmark/harness/flops.relpos_calls: K1's
window attention over each window's valid queries, K2's global attention)
over the device time of its kernel in the profiled stretch, symbol
``KERNELS`` (flmm_tpu_torch/csrc/relpos_attention_sm90.cu)."""

from benchmark.harness import flops

UNIT = "%"
KERNELS = ("relpos_sm90_kernel",)


def read(run):
    cfg = run.model_cfg()
    base = cfg["base"] if "base" in cfg else cfg
    per_image = sum(flops.bound_s(f, b) for f, b in
                    flops.relpos_calls(base["sam"]["encoder"]))

    def bound(k):
        return per_image * run.pool_batches[k]["mask_valid"].shape[0]

    return run.kernel_roofline(KERNELS, bound)
