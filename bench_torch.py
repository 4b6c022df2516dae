"""End-to-end grounding throughput of the PyTorch + CUDA port on one GPU:
``python bench_torch.py`` is ``python -m flmm_tpu_torch.bench`` (see that
module for the BENCH_* knobs and the JSON line it prints)."""

from flmm_tpu_torch.bench import main

if __name__ == "__main__":
    main()
