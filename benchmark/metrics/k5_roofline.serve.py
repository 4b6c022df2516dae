"""K5's share of its roofline (%): the least time of the flash-capture
kernel's calls a forward (benchmark/harness/flops.k5_calls: the valid
queries' causal pairs and the merge of the text rows; q, k, v, o, lse and
the merged capture moved once) over the device time of its kernels in the
profiled stretch, symbols ``KERNELS`` (flmm_tpu_torch/csrc/
flash_capture_sm90.cu)."""

from benchmark.harness import flops

UNIT = "%"
KERNELS = ("flash_fwd_sm90_kernel", "merge_flags_kernel",
           "merged_capture_sm90_kernel")


def read(run):
    cfg = run.model_cfg()
    base = cfg["base"] if "base" in cfg else cfg
    n_img = cfg.get("n_img_max", base["num_img_tokens"])

    def bound(k):
        return flops.bound_s(*flops.k5_calls(
            base["llm"], run.pool_batches[k], base["img_start"], n_img))

    return run.kernel_roofline(KERNELS, bound)
