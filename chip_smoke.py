"""Smoke test of the PyTorch + CUDA port (flmm_tpu_torch) on one Hopper GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. check the card (CUDA available; name and power limit from nvidia-smi);
2. build the kernel library from flmm_tpu_torch/csrc with nvcc (sm_90a),
   one nvcc per source, all started together;
3. hold each main-path kernel against its plain PyTorch version at the
   shapes the paths below give it, and time both: K1 window block, K2
   global attention, K3 LN + qkv and K4 proj + LN + MLP at the
   DeepSeek-VL-1.3B serving shapes, K3 and K4 again at the CLIP-L/336 shape
   of the anyres tower (quick_gelu) and at the SAM-448 training rows, K5
   flash capture at the LLaVA-NeXT decoder shape, K2 at the SAM-448 grid
   (side 28) and K6 window attention at the SAM-448 training shape; K7
   tower flash attention at the HPT tower shape (head dim 72, read in place
   from the qkv rows) and at the CLIP shape (S = 577, head dim 64), also as
   views of qkv rows at S = 577 and head dims 72 and 64, K8 LN2 +
   MLP and K10 the attention half of a global SAM block at the SAM-1024
   global-layer shape (K10's f32 result also bit for bit equal across two
   runs), K5 again at the HPT decoder shape (GQA 32/8); K9 raw capture at
   the DeepSeek-VL-1.3B aligned decoder shape and at the HPT shape, the K11
   relayout pair at the bs-8 and bs-4 SAM-1024 grid (bit for bit equal to
   the plain pair, also in f32) and K12 v10, the spatial window attention,
   at the bs-8 grid padded to 70 x 70; then K1, K2, K3, K4, K5, K6, K8 and
   K10 once more at the shapes phase 13's bench gives them (bs 8 at the
   SAM-1024 grid, the SigLIP rows, the aligned decoder); and the global
   variants v11, v3, v6 and v7 of K12 (all on K2's core, csrc/
   relpos_attention_sm90.cu, in their softmax modes) at the bs-4 and bs-8
   SAM-1024 grid and at the grid sides 28, 5 and 80 where their JAX
   preconditions take them, each also beside K2 on the same inputs and its
   kernel alone beside its wrapper, with the memory its wrapper adds above
   its inputs asserted to be its output and tables; the
   window variants v1, v6, v7 and v8 of K12 at the kernel bench's bs-8 shape
   (3200 window-heads, contiguous and as views of the windowised qkv) and
   at the SAM-768 bs-4 shape, each also beside K6; and K6, K3, K4 and K2 at
   the shapes the SAM-768 and SAM-640 points of the size sweep give them
   (padded grids of 16 and 9 windows an image, global sides 48 and 40);
   the global variants v1, v2 and v4 and the window variant v2 of K12 at the
   same shapes as the other variants, and K3 and K4 at the CLIP-L rows of
   the LLaVA-1.5 and HPT-Air towers (bs 4, 577 and 785 tokens an image);
   the augmented-operand window variants v3, v4 and v5 of K12 at the shapes
   of the other window variants; K3, K4 and K8 at the widths of SAM ViT-B
   (C = 768) and ViT-H (C = 1280), K2's kernel alone beside its wrapper and
   K1's three launches one by one beside the whole; K5 and K9 (one wgmma +
   TMA source, csrc/flash_capture_sm90.cu) with the device time of each
   pass (profiler), K5's merged capture bit for bit equal across two runs
   and within 1e-4 of its f32 plain version, and
   F.scaled_dot_product_attention(is_causal=True) on the same q, k, v as a
   yardstick for the attention pass alone; every window variant
   and v10 (one window core, csrc/window_attention_sm90.cu) with its
   kernel alone beside its wrapper, and the memory the v2 wrapper adds above
   its inputs; K2 at the grid sides 5 (the tiny configs' SAM-80), 7, 80
   (SAM-1280) and 128 (SAM-2048), K6 at window side 7 and K10 at side 5;
   K1 over one image's 25 windows, K2 over one image's 16 heads (S =
   4096), K3 and K4 over one image's SAM global rows (N = 4096) and the
   SigLIP rows of one and two images (N = 576, 1152): the generation
   path's shapes; K5 at the DeepSeek-VL-7B aligned decoder layer (B = 4,
   32 heads, S = 768, the image block of 576 at 128) and at the MGM-HD
   decoder layer (B = 2, 32 heads of 128, S = 3200, the image block of 2880
   at 128, no key holes); K5 above the 32 masks one block of its merged
   pass takes (chunks of 32), the masks over the caption rows densely: at
   the LLaVA-NeXT shape with 40 and 64 masks, at the HPT shape and on
   LLaVA-NeXT's rows 1664-3199 with 40.
   Each kernel's time
   stands beside its bound (the larger of its operations over the card's
   peak bf16 rate and its operand bytes over the peak memory rate) and,
   where one PyTorch call computes the same function, that call's time;
4. serve 3 distinct synthetic bs-4 requests through the DeepSeek-VL-1.3B
   grounding forward at full width (DeepSeek-LLM-1.3B + SigLIP-L/384 + SAM
   ViT-L at 1024, bf16, random weights from a seed): output shapes, finite
   values and the exact kernel launch counts;
5. compare that forward with the all-plain forward on the same batch;
6. serve 3 distinct synthetic bs-2 anyres requests through the LLaVA-NeXT
   (Vicuna-7B) grounding forward at full width (CLIP-L/336 over a base view
   and up to 4 tiles, Vicuna-7B over S=3200 with the image block at 128,
   SAM ViT-L at 1024), one 2x2 and one 3x1 pinpoint grid per batch, so the
   decoder's key holes differ per sample: shapes, finite values, launches;
7. compare that forward with the all-plain forward (eager S x S capture);
8. train the DeepSeek-VL-1.3B heads at the SAM-448 schedule at full width
   through the port's train step (flmm_tpu_torch.train.loop) on the
   trainer's random synthetic stream at bs 8: one warm-up and 5 timed
   steps with finite losses and gradient norms and the exact launch counts
   per step, every trainable subtree changed and the frozen tree bit for
   bit unchanged, and a checkpoint save / restore round trip;
9. compare one training step's loss and gradients with the all-plain
   path's on the same state and batch, and time the plain path's steps;
10. check that 10 steps on one repeated batch lower its loss (phases 8-10
    run under torch.use_deterministic_algorithms, so that the state the
    steps reach, and with it phase 9's reading, repeats from run to run);
11. serve 3 distinct synthetic bs-4 requests through the HPT-Air-1.5
    grounding forward at full width and depth (Llama-3-8B with GQA 32/8
    over S=1280 with the 1024-token image block at 128, SigLIP-SO400M/14 at
    448 with the flash switch on, SAM ViT-L at 1024 with the whole-block
    global switch on): shapes, finite values, launches;
12. compare that forward, its tower features and its SAM embedding with the
    all-plain forward;
13. run the kernel bench (flmm_tpu_torch.kernel_bench, all 11 ops) in
    process at bs 8 and full width: SAM ViT-L at 1024, SigLIP-L/384 and
    DeepSeek-LLM-1.3B at full depth, the window-only and global-only
    encoders at depth 12 and 6: every time finite and positive, the
    flash / whole-block agreement rows, the relayout round trip exact, and
    the exact launch counts of every op (`window` times v1, v6, v7, v8, v9,
    v2, v3, v4 and v5, `global` v8, v3, v6, v7, v11, v1, v2 and v4;
    `encoder` and `heads` run the bench's defaults, w=v6 and g=v6, and
    `encoder` once more with w=v3, of which the window kernel is launched 0
    times: at SAM-1024 every window layer is K1);
14. run the twin of bench.py (flmm_tpu_torch.bench.run) in process:
    DeepSeek-VL-1.3B at bs 4, SAM-1024 and S=672, full width and depth, with
    the global kernel knob at v11, 3 timed forwards after 2 warm-ups on the
    kernel path and on the all-plain path: finite logits and the exact
    launch counts per forward;
15. compare that forward with the v8 forward and with the all-plain forward
    on one batch, and put the largest log2-domain score of each global layer
    on record (v11's precondition);
16. run the twin once more at its default (v8);
17. run the SAM size sweep (flmm_tpu_torch.schedule_bench.run) in process
    at SAM-768 and SAM-640, bs 4, 3 timed forwards a point, at full width
    and depth: both grids are padded to whole windows and have fewer than 25
    windows an image, so the 20 window layers go K3 -> K6 -> K4: the exact
    launch counts per forward;
18. compare the kernel forward with the all-plain forward at both sizes on
    weights with non-zero qkv biases (the pad tokens' keys and values);
19. run the SAM ViT-L encoder alone at 768, bs 4, through each window
    kernel name (v9, v1, v6, v7, v8, v2, v3, v4, v5): 20 launches of the
    named wrapper and none of the others, and the embedding beside the v9
    encoder's and the all-plain encoder's;
20. run the family matrix (flmm_tpu_torch.bench_families.main) over
    LLaVA-1.5-7B (Vicuna-7B + CLIP-L/14-336, global kernel knob at v1) and
    HPT-Air (a 7B Llama decoder + CLIP-L/14 at 392 over a resampled
    pos-embed, knob at v4), each a child process of the bench.py twin at
    full width and depth, bs 4, SAM-1024: a bf16 row without error, finite
    logits, the exact launch counts per forward; MGM-Gemma-2B (CLIP-L/336 +
    ConvNeXt-L at 768, the global kernel at its default v8) the same way
    (K1/K2/K3/K4 20/4/27/27); and HPT-Air-1.5's int8_llm point
    (BENCH_QUANT_LLM=1, the W8A8 decoder fabricated leaf by leaf), a row
    without error that phase 35 sets beside the bf16 one;
21. build both families in process and compare the forward through each of
    the global kernels v1, v2 and v4 (counts at 0 just before, read just
    after) with the all-plain forward of the same weights;
22. run the eval loop (flmm_tpu_torch.evalsuite.runner.run_eval) over 32
    synthetic samples (flmm_tpu_torch.data.synthetic.synthetic_samples:
    48-160 px uint8 images, up to 8 masks) at DeepSeek-VL-1.3B, SAM-1024,
    bs 8, S=704 with the buckets 608 / 640 / 704, through the port's host
    processors and batch builder: RefCOCO and PNG scores, finite, over
    every valid mask, launches 20/4/28/28 a forward, the kernel forward's
    SAM logits beside the all-plain forward's batch by batch, the ground
    truth as logits scoring above 85 cIoU and mIoU; then one batch of 8 at
    SAM-768 through window_kernel = v3, v4, v5 and v9 (20 launches of the
    named wrapper a forward, logits beside v9's); forward ms, host ms,
    samples/s, peak memory and the device's busy share over the loop;
23. report times;
24. run the generation path (flmm_tpu_torch.generation.api, the grounder
    API) at DeepSeek-VL-1.3B with lm_head at full width and depth, random
    weights from a seed and a word-level stand-in tokenizer, through
    make_grounder("deepseek_vl"): answer (32 new tokens with the per-step
    capture) on a 480 x 640 image, ground on two token spans of the answer
    and on a noun chunk's span where the chunker finds one, visual_cot_v1
    on that image and visual_cot_v2 on a 333 x 500 one, each call with the
    exact launch counts (answer K3 / K4 24 each, the SigLIP tower at bs 1;
    ground K1 20, K2 4, K3 / K4 4, the SAM encoder at bs 1; each CoT both
    and the two-image round's tower at bs 2: K3 / K4 52), finite outputs of
    the expected shapes, the bf16 KV-cache decode's rows and hidden states
    at steps 0, 1 and the last against the decoder's full forward over the
    grown sequence (corr >= 0.999), and the all-plain grounder on the same
    weights beside it: prefill capture and prompt hidden (corr >= 0.999),
    first-step logits (>= 0.99), how long a prefix of the tokens agrees,
    ground's SAM low-res logits on one answer's maps (>= 0.99), and its
    coarse (>= 0.999) and SAM low-res logits on each path's own prompt
    capture over the question, as visual_cot_v2 grounds it; all read from
    the answer entry point (its _generate's result kept on the way);
    from CUDA events the first token's ms (answer with one new token), split
    into what comes before _generate (the host's image preparation,
    tokenisation, the tower) and _generate (prefill and the first step), and
    decode ms a token (the 32-token _generate less that), tokens/s,
    ground and CoT ms on the host clock, the device's busy share of one
    answer (profiler) and peak memory;
25. files in, scores out: decode every image of the committed fixture tree
    (tests/data: JPEGs at COCO sizes in 4:2:0, 4:2:2, 4:4:4, grey and with
    restart markers, panoptic PNGs) with the PIL-free decoder, each to the
    sha256 PIL's decode gave (tests/data/manifest.json); write a
    DeepSeek-VL-1.3B checkpoint at full width and depth in the
    deepseek-vl-1.3b-chat layout (two bf16 safetensors shards), a SAM ViT-L
    .pth in the official layout and a released F-LMM trained .pth, from a
    seed, into a temporary directory, and load them back through
    registry.get_loader and restore_trainable bit for bit; then run
    flmm_tpu_torch.eval_refcoco (8 splits, --debug) and eval_png in process
    at their defaults (bs 8, S=704, SAM-1024) with the word-level tokenizer:
    launches 20/4/28/28 a forward, every expression's and narrative mask's
    score finite, the SAM low-res logits of every batch against the
    all-plain forward's (corr >= 0.99), and each CLI's own chain fed the
    ground truth as +-8 logits above 85 cIoU per split and 0.85 AA; load
    GB/s, decode ms an image, samples/s, forward and host ms a batch (the
    host's split into decode, reads and the batch builder) and peak memory.
26. DeepSeek-VL-7B, the hybrid tower (DeepSeek-LLM-7B, 30 layers x 32
    heads; SigLIP-L/384 beside SAM-B at 1024 through the split projector;
    SAM ViT-L at 1024), random weights from a seed with non-zero rel-pos
    tables in both SAM trunks, hd_alpha 0.5 and a neck_hd apart from the
    encoder neck: serve 2 bs-4 requests eagerly (img_start 5, S=672;
    K1/K2/K3/K4/K5 20/4/28/28/0 a forward; the SAM-B trunk runs plain) and
    aligned (img_start 128, S=768; K5 30), each beside the all-plain
    forward (image embeddings, maps, SAM embedding, hidden corr >= 0.999,
    logits >= 0.99; the SAM-B output bit for bit equal), with the device ms
    of each stage (SAM-B trunk, SigLIP, projector, decoder capture, SAM
    ViT-L encoder, heads) on both paths; bench_torch.py's row at
    BENCH_PRESET=7b; and 3 steps of the trainer CLI at --preset 7b
    --sam-size 448 --batch-size 8 (finite losses, launches 0/4/48/48/0 and
    K6 20 a step, the frozen tree's per-leaf checksums unchanged);
27. LLaVA-NeXT over Mistral-7B (GQA 32/8), built by the bench.py twin at
    bs 2: one kernel forward with its exact launches (20/4/27/27/32) beside
    the all-plain forward, and bench_torch.py's row at
    BENCH_FAMILY=llava_next BENCH_PRESET=mistral_7b;
28. MGM-Gemma-2B (Gemma-2B, 18 layers x 8 heads of 256, MQA, the (1 + w)
    norm, gelu_tanh, the scaled embedding, the tied head; CLIP-L/336 read
    at layer -2; ConvNeXt-L at 768 with its layer scales at 0.1; the
    patch-info mining resampler; SAM ViT-L at 1024), random weights from a
    seed: serve 2 bs-4 requests of synthetic samples through
    build_mgm_batch (S = 704, the eager capture): shapes, finite values,
    K1/K2/K3/K4/K5 20/4/27/27/0 a forward; beside the all-plain forward
    (image embeddings, i.e. the CLIP features plus the mined tokens through
    the projector, stitched maps, SAM embedding, hidden corr >= 0.999,
    logits >= 0.99); the device ms of each stage (CLIP tower, ConvNeXt,
    resampler + projector, decoder capture, SAM ViT-L, heads) on both paths
    and peak memory;
29. MGM-Vicuna-7B-HD with the image block at 128: 2 bs-2 requests at S =
    3200, each image a 2 x 2 crop grid plus the global crop (2880 image
    tokens, the 5 crops in one tower batch) and ConvNeXt-L at 1536, the
    maps stitched to 48 x 48 beside the upsampled global map: the same
    checks, K5 32 a forward; the plain path captures eagerly (S x S);
30. MGM-Mixtral-8x7B, the MoE MLP at full width (8 experts of 4096 x 14336
    computed densely, the top 2 a token): the decoder cut to 4 of its 32
    layers (the whole model is 93 GB in bf16), the U-Net's in_channels
    from the cut depth; one bs-4 forward with K1/K2/K3/K4 20/4/27/27 beside
    the all-plain one;
31. the grounder API at MGM-Gemma-2B through make_grounder("mgm") with a
    word-level stand-in tokenizer carrying Gemma's special ids: answer (32
    new tokens; CLIP K3 / K4 23 each), ground on one span (SAM K1/K2/K3/K4
    20/4/4/4) and visual_cot_v1 (20/4/50/50: the two-image round encodes
    both images in one tower batch), the prefill capture and prompt hidden
    (corr >= 0.999), the tied head's first-step logits (>= 0.99) and
    ground's SAM logits (>= 0.99) beside the all-plain grounder's; times
    and peak memory;
32. MGM files in, scores out: a full-width gemma_2b model from a seed
    written as MGM's main checkpoint (model.*, model.mm_projector.*,
    model.vlm_uni_*), a CLIP-L HF tower directory and an open_clip
    ConvNeXt-L open_clip_pytorch_model.bin, with a SAM ViT-L .pth and the
    released-layout heads, loaded back through get_loader("mgm") and
    restore_trainable bit for bit; eval_refcoco --family mgm --preset
    gemma_2b --debug and eval_png --family mgm over tests/data with phase
    25's gates (20/4/27/27 a forward) but its ground-truth pass, which
    phase 25 makes for the CLIs' shared chain.
33. training on real files: a train layout of tests/data in a temporary
    directory (tests/train_fixtures.py: RefCOCO/+/g refs rewritten to the
    train split, the PNG val files as train2017, the narratives listed 4
    times: 79 samples), and the trainer CLI (python -m
    flmm_tpu_torch.train) in process over its PNG + RefCOCO/+/g stream
    with a word-level stand-in tokenizer, 1 warm-up and 3 timed steps a
    run: (a) DeepSeek-VL-1.3B at SAM-1024, bs 8, S = 704, from phase 25's
    checkpoints (--checkpoint, --sam-checkpoint; K1/K2/K3/K4 20/4/28/28 a
    step), 11 steps (8 timed inside epoch 0 and 1 inside epoch 1, step 10,
    the first of epoch 1, timed apart), the whole run under the
    deterministic switch of phases 8-10; (b) LLaVA-NeXT-Vicuna-7B, bs 2,
    S = 3200, the image block at 128, --max-masks 40 (K5 32 a step, 40
    masks wide); (c) MGM-Gemma-2B, bs
    4 (20/4/27/27/0); (d) HPT-Air-1.5 on the synthetic stream, bs 4, with
    phase 11's kernel switches, which the trainer CLI has no flag for, set
    through a wrapped registry.get_config (K1 20, K7 / K8 / K10 26 / 4 /
    4; the preset as the CLI gives it has both switches off); each with the exact launches a step, finite losses,
    every trainable subtree changed, the frozen tree's per-leaf checksums
    unchanged and the checkpoint the trainer wrote restored bit for bit;
    (a) also its frozen tree bit for bit the loaders' and its trainable SAM
    the checkpoint's at the first step, and one step's loss (1%) and
    gradients (corr >= 0.99 per trainable subtree) against the all-plain
    step's on the last batch; (e) run (a) with --profile 2, whose trace
    names the kernels; s/step, img/s, data-wait ms a step and peak memory.
34. the interactive slice on phase 25's files, two tests/data JPEGs
    decoded by the port's reader: (a) SamPredictor at SAM-1024, set_image
    (20/4/4/4) then predict with a point, a box and the box with its own
    low-res logits as the mask prompt (0 launches), the embedding against
    the all-plain encoder's (corr >= 0.999) and the low-res logits
    against the all-plain predictor's (>= 0.99), masks at the image's size;
    (b) AutomaticMaskGenerator at 32 x 32 points, once at pass-all
    thresholds (the decode's logits on the kernel vs the plain embedding
    >= 0.99, every record's RLE an image-size mask of its area and box),
    once at the defaults for the time (encode, one-call decode, host
    postprocess, peak memory); (c) export_sam_decoder at full width,
    torch.export's program loaded back against the eager decoder (max
    |diff| / max |eager| <= 1e-4) and its size; (d) grounded_conversation
    single shot and --interactive over two turns on a scripted stdin (a
    stand-in tokenizer whose ids decode to nouns, so that every answer
    has a phrase to ground), each overlay PNG read back as written,
    launches per answer 24/24 and per ground 20/4/4/4; (e) visual_cot_inference v1, v2, v3 over a 2-item
    VisCoT JSON (20/4/52/52 a v1 / v2 item, 24/24 a v3 item), every record
    complete; (f) infer_png --synthetic --preset 1_3b, two PNGs,
    20/4/28/28.
35. the int8 slice and the two repairs: (a) on the host, with none of
    JAX, orbax, tensorstore, zstandard or PIL loaded, the committed Orbax
    state of the JAX trainer (tests/data/orbax, runtime/zstd_decode.cpp and
    convert/orbax.py) restored, every leaf the sha256 the fixture script
    recorded, and every image of another kind (tests/data/kinds:
    progressive, CMYK, YCCK, 4:1:1 / 4:4:0 / 3 x 1 / 4 x 2 JPEGs,
    Adam7-interlaced and 16-bit PNGs) decoded to PIL's sha256; then
    eval_refcoco at the tiny preset on the card with --trained that Orbax
    directory (its trainable tree the restored one); (b) int8_matmul's
    int32 product (torch._int_mm) at SAM ViT-L's SAM-1024 bs-4 shapes,
    Llama-3-8B's at bs 4 x 1280 and a 5-row decode step, equal to the
    exact product on the CPU, and its output against its plain twin on the
    card, each beside the bf16 product's time; (c) DeepSeek-VL-1.3B at the
    bench preset with and without quantize_frozen_sam in one call: mean
    |sigmoid difference| of the SAM logits under 0.02, launches a forward on
    the int8 side K6 20, K2 4, K3 / K4 24 (SigLIP), K1 / K10 / K8 0, ms a
    forward and peak GB both ways; (d) eval_refcoco and eval_png
    --int8-sam on phase 25's checkpoints (launches 0/4/24/24 and K6 20 a
    forward, kernel vs all-plain logits), their scores beside phase 25's;
    (e) bench_torch.py's rows with BENCH_QUANT_LLM=1 beside the bf16 rows
    at DeepSeek-VL-1.3B and HPT-Air-1.5 (phase 20's int8_llm child), each
    int8 row launching what its bf16 row does.
36. the parallel slice: (a) eval_refcoco (its first split) and eval_png
    with --sharded-eval over phase 25's files, a group of one on nccl:
    results equal to phase 25's, 20/4/28/28 a forward; (b) the trainer
    with --multihost under a one-rank torchrun environment set in process
    (DeepSeek-VL-1.3B at SAM-448, bs 8, 3 steps, deterministic): every
    logged metric and the written state bit for bit those of the same
    steps without it; (c) two ranks spawned on the card (nccl with a card
    a rank, else gloo with both on cuda:0), DeepSeek-VL-1.3B at full
    width, bs 4, S = 672, against the one-rank forward: tp = 2 (capture
    and hidden corr >= 0.999, SAM and next-token logits >= 0.99;
    launches a forward K3 48, K4 24, K6 20, K2 4), fsdp = 2 bit for bit
    (20/4/28/28), the 2-stage GPipe capture of 2 microbatches (capture
    and hidden >= 0.999), and the sequence split over the two ranks
    (forward_capture's seq_axis, the decoder alone): at S = 672 eager (0
    launches) and at the image block at 128, S = 768, with K5 on each
    rank's 384 query rows (24 launches a rank), capture, hidden and
    last_hidden corr >= 0.999 against the one-rank decoder; each rank's ms
    a forward (CUDA events), peak GB and launches, the launches the
    kernels line's "parallel" entry.  Phase 3 holds K5 on one rank's rows
    (q_offset) at the sp shape (B = 4, H = 16, S = 768, rows 384-767) and
    at LLaVA-NeXT's (B = 2, H = 32, S = 3200, rows 1664-3199).
37. the three measurement scripts through their entry points:
    fused_piece_bench whole (K3 / K4 / K8 at the bs-8 ViT-L rows, each
    within 2e-2 of its plain piece, 12 launches each: 2 warm-up + 10 timed
    calls), train_overlap_bench at DeepSeek-VL-1.3B bs 4, 3 steps, 4
    workers (20/4/28/28 a step over its 8 steps; every time positive),
    python -m flmm_tpu_torch.sam_size_accuracy_proxy at SAM sizes 1.0 and
    0.5 of the tiny twin, one seed, one process a size, both at once: at
    each size the last steps' mean loss below the first steps' and their
    aiou above; the scripts' JSON lines logged, the launches the kernels
    line's "measure_scripts" entry.

The last line of standard output is one JSON object with the device; the
line before it is the card's name and power limit, and the one before that
holds the per-kernel results.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from flmm_tpu_torch import bench as e2e_bench
from flmm_tpu_torch import bench_families, eval_png, eval_refcoco, \
    fused_piece_bench, kernel_bench, registry, schedule_bench, trace, \
    train_overlap_bench
from flmm_tpu_torch.configs import deepseek_vl, llava_next
from flmm_tpu_torch.configs import mgm as mgm_configs
from flmm_tpu_torch.convert import export, sam_weights
from flmm_tpu_torch.convert import load as load_mod
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data import collate, image_io
from flmm_tpu_torch.data import mgm as mgm_data
from flmm_tpu_torch.data import io as data_io
from flmm_tpu_torch.data.collate import BatchSpec, build_batch
from flmm_tpu_torch.data.llava_next import synthetic_anyres_batch
from flmm_tpu_torch.data.processors import ProcessorConfig, sam_preprocess
from flmm_tpu_torch.data.refcoco import rle_to_mask
from flmm_tpu_torch.data.synthetic import synthetic_batch, synthetic_samples
from flmm_tpu_torch.evalsuite import cli as eval_cli
from flmm_tpu_torch.demo import grounded_conversation, infer_png
from flmm_tpu_torch.evalsuite import metrics, runner
from flmm_tpu_torch.generation import api as generation
from flmm_tpu_torch.generation.noun_chunks import char_span_to_token_span, \
    noun_chunks
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.models.frozen import llava_next as llava_next_model
from flmm_tpu_torch.models.frozen import mgm as mgm_model
from flmm_tpu_torch.models.llm import decoder as llm_decoder
from flmm_tpu_torch.models.mask_head import unet
from flmm_tpu_torch.models.sam import amg, predictor
from flmm_tpu_torch.models.sam import image_encoder as sam_encoder
from flmm_tpu_torch.models.sam import mask_decoder as sam_decoder
from flmm_tpu_torch.models.sam import prompt_encoder as sam_prompt
from flmm_tpu_torch.models.vision import convnext, sam_tower, vit
from flmm_tpu_torch.ops import _cuda
from flmm_tpu_torch.ops import boundary, flash_attention, fused_block, \
    global_block, masks, sam_flash, sam_flash_experiments, window_block
from flmm_tpu_torch.ops._matmul import matmul_f32
from flmm_tpu_torch.ops import masks as mask_ops
from flmm_tpu_torch.parallel import frozen as shard
from flmm_tpu_torch.parallel import mesh as mesh_lib
from flmm_tpu_torch.parallel import pipeline as pipe
from flmm_tpu_torch.train import __main__ as trainer_cli
from flmm_tpu_torch.train import checkpoint as ckpt
from flmm_tpu_torch.train import loop as train_loop
from flmm_tpu_torch.visual_cot import visual_cot_inference
from tests import checkpoint_writers
from tests.train_fixtures import joint_samples, make_train_root

BS, SEQ, MASKS, TEXT = 4, 672, 8, 12
# K5 above the 32 masks one block of its merged pass takes (phase 3) and
# the LLaVA-NeXT trainer's --max-masks (phase 33 (b))
WIDE_MASKS = (40, 64)
# LLaVA-NeXT requests: bs 2, the vicuna template's 35 prompt tokens padded
# to an image block at 128, (h, w) of the two images: 2x2 and 3x1 grids
ANYRES_BS, ANYRES_IMG_START, ANYRES_PROMPT = 2, 128, 35
ANYRES_SIZES = ((600, 640), (900, 280))
# HPT-Air-1.5 requests: the image block of 1024 tokens at 128, S = 128 + 1024
# + 40 rounded up to 128
HPT_IMG_START, HPT_SEQ = 128, 1280
# published dense peaks of one H100 SXM: bf16 tensor-core rate, memory rate
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
SLEEP_CYCLES = 50_000_000  # the GPU sleep ahead of a timed loop (cuda_ms)
# kernel vs plain version, both bf16: max |diff| over max |plain| and the
# correlation of the flattened outputs
KERNEL_REL_ERR, KERNEL_CORR = 2e-2, 0.999
# K5's merged capture vs its f32 plain version: bf16 hi + lo products keep
# about f32 accuracy
MERGED_REL_ERR = 1e-4
# kernel forward vs all-plain forward (bf16 differences compound through
# 24 SAM blocks, the 23-24 tower blocks and the decoder)
FORWARD_CORR = {"sam_embedding": 0.999, "attn": 0.999,
                "image_embeddings": 0.999,
                "vision_features": 0.999, "hidden": 0.999,
                "coarse_logits": 0.99, "sam_logits": 0.99}
# training: bs 8 at the SAM-448 schedule, scripts/train.py's random stream
# (synthetic_batch defaults: S = 613, up to 3 masks of up to 4 tokens)
TRAIN_BS, TRAIN_SAM, TRAIN_STEPS, REPEATED_STEPS = 8, 448, 5, 10
TRAIN_LR = 1e-4  # the recipe's, also for the repeated batch
# kernel step vs all-plain step: relative loss difference, and the
# correlation of each trainable subtree's flattened gradient
STEP_LOSS_REL, STEP_GRAD_CORR = 0.01, 0.99
SUBTREES = ("unet", "text_proj", "text_layer_weights", "sam/prompt",
            "sam/decoder")
# the kernel bench: the JAX script's batch and depth, 3 timed calls per
# measurement after its 2 warm-up calls
BENCH_BS, BENCH_DEPTH, BENCH_ITERS = 8, 12, 3
BENCH_CORR = 0.999  # flash path vs whole-block path of one encoder
EXPECTED_LAUNCHES = {  # per forward when serving, per step when training
    "deepseek_vl_1_3b": {
        "window_block": 20, "sam_global_attention_v8": 4,
        "fused_ln_qkv": 28, "fused_proj_ln_mlp": 28,
        "flash_attention_with_merged_capture": 0,
        "sam_window_attention_v9": 0, "plain_flash_attention": 0,
        "fused_ln_mlp": 0, "global_attn_block": 0},
    "llava_next_vicuna_7b": {
        "window_block": 20, "sam_global_attention_v8": 4,
        "fused_ln_qkv": 27, "fused_proj_ln_mlp": 27,
        "flash_attention_with_merged_capture": 32,
        "sam_window_attention_v9": 0, "plain_flash_attention": 0,
        "fused_ln_mlp": 0, "global_attn_block": 0},
    "deepseek_vl_1_3b_train_sam448": {
        "window_block": 0, "sam_global_attention_v8": 4,
        "fused_ln_qkv": 48, "fused_proj_ln_mlp": 48,
        "flash_attention_with_merged_capture": 0,
        "sam_window_attention_v9": 20, "plain_flash_attention": 0,
        "fused_ln_mlp": 0, "global_attn_block": 0},
    # the 7B hybrid: the SAM-B trunk runs plain, so the 1.3B path's counts;
    # aligned, K5 in each of the 30 decoder layers
    "deepseek_vl_7b": {
        "window_block": 20, "sam_global_attention_v8": 4,
        "fused_ln_qkv": 28, "fused_proj_ln_mlp": 28,
        "flash_attention_with_merged_capture": 0},
    "deepseek_vl_7b_aligned": {
        "window_block": 20, "sam_global_attention_v8": 4,
        "fused_ln_qkv": 28, "fused_proj_ln_mlp": 28,
        "flash_attention_with_merged_capture": 30},
    "deepseek_vl_7b_train_sam448": {
        "sam_global_attention_v8": 4, "fused_ln_qkv": 48,
        "fused_proj_ln_mlp": 48, "sam_window_attention_v9": 20},
    "llava_next_mistral_7b": {
        "window_block": 20, "sam_global_attention_v8": 4,
        "fused_ln_qkv": 27, "fused_proj_ln_mlp": 27,
        "flash_attention_with_merged_capture": 32},
    # the tower's K3 / K4 gate is closed (mlp_dim 4304 % 512 != 0), 26 of its
    # 27 layers run (features at layer -2), and the 4 global SAM layers go
    # K10 + K8 instead of K3 + K2 + K4
    "hpt_air_1_5": {
        "window_block": 20, "sam_global_attention_v8": 0,
        "fused_ln_qkv": 0, "fused_proj_ln_mlp": 0,
        "flash_attention_with_merged_capture": 32,
        "sam_window_attention_v9": 0, "plain_flash_attention": 26,
        "fused_ln_mlp": 4, "global_attn_block": 4},
}
# per timed or warm-up call of each bench op (kernels not named: 0).  The SAM
# encoder at 1024 runs 20 window layers through K1 and 4 global layers
# through K3 + K2 + K4; wb is 12 window layers through K3 + K6 + K4, then
# through K1; gb is min(depth, 6) global layers through K3 + K2 + K4, then
# through K10 + K8; the SigLIP tower is 24 layers of K3 + K4; the decoder's
# third variant runs K5 in its 24 layers.
BENCH_GB_DEPTH = min(BENCH_DEPTH, 6)
# the global variants the `global` op times; `encoder` and `heads` run the
# bench's default, g=v6
BENCH_GLOBAL_VARIANTS = ("v8", "v3", "v6", "v7", "v11", "v1", "v2", "v4")
GLOBAL_WRAPPER = {v: "sam_global_attention" + ("" if v == "v1" else f"_{v}")
                  for v in BENCH_GLOBAL_VARIANTS}
_SAM_1024 = {"window_block": 20, "fused_ln_qkv": 4,
             "sam_global_attention_v6": 4, "fused_proj_ln_mlp": 4}
# the window variants the `window` op times: the bench's default, v8, v9, v2
# and the augmented-operand variants
NEW_WINDOWS = ("v3", "v4", "v5")
BENCH_WINDOW_VARIANTS = ("v1", "v6", "v7", "v8", "v9", "v2") + NEW_WINDOWS
WINDOW_WRAPPER = {"v1": "sam_window_attention", **{
    v: f"sam_window_attention_{v}" for v in BENCH_WINDOW_VARIANTS[1:]}}
BENCH_LAUNCHES = {
    "window": {WINDOW_WRAPPER[v]: 1 for v in BENCH_WINDOW_VARIANTS},
    "global": {GLOBAL_WRAPPER[v]: 1 for v in BENCH_GLOBAL_VARIANTS},
    "encoder": _SAM_1024,
    "wb": {"fused_ln_qkv": BENCH_DEPTH, "sam_window_attention_v9": BENCH_DEPTH,
           "fused_proj_ln_mlp": BENCH_DEPTH, "window_block": BENCH_DEPTH},
    "gb": {"fused_ln_qkv": BENCH_GB_DEPTH,
           "sam_global_attention_v8": BENCH_GB_DEPTH,
           "fused_proj_ln_mlp": BENCH_GB_DEPTH,
           "global_attn_block": BENCH_GB_DEPTH,
           "fused_ln_mlp": BENCH_GB_DEPTH},
    "boundary": {"windowize": 1, "dewindowize": 1},
    "tower": {"fused_ln_qkv": 24, "fused_proj_ln_mlp": 24},
    "decoder": {"flash_attention_with_merged_capture": 24},
    "window_path": {"sam_window_attention_v9": 1,
                    "sam_window_attention_v10": 1},
    "heads": _SAM_1024,
    "rtt": {},
}
# MGM (phases 28-32), per forward: CLIP-L/336's 23 layers (features at layer
# -2; the crops of a request in one batch) and SAM's 4 global layers go
# K3 / K4, SAM's 20 window layers K1, its global attention K2; ConvNeXt, the
# resampler and the MoE MLP run plain (plain XLA in the JAX package); HD's
# 2880-token image block at 128 takes K5 in each of Vicuna-7B's 32 layers,
# the single-crop presets the eager capture
_MGM = {"window_block": 20, "sam_global_attention_v8": 4,
        "fused_ln_qkv": 27, "fused_proj_ln_mlp": 27}
EXPECTED_LAUNCHES.update({
    "mgm_gemma_2b": _MGM,
    "mgm_vicuna_7b_hd": {**_MGM, "flash_attention_with_merged_capture": 32},
    "mgm_mixtral_8x7b_4_layers": _MGM,
    # training on real files (phase 33), a step: the frozen forward's
    # launches (the stack takes no gradient); HPT-Air-1.5 with phase 11's
    # switches but the preset's image block at 10 (the eager capture)
    "deepseek_vl_1_3b_train_real": EXPECTED_LAUNCHES["deepseek_vl_1_3b"],
    "llava_next_vicuna_7b_train_real":
        EXPECTED_LAUNCHES["llava_next_vicuna_7b"],
    "mgm_gemma_2b_train_real": _MGM,
    "hpt_air_1_5_train_synthetic": {
        "window_block": 20, "plain_flash_attention": 26,
        "fused_ln_mlp": 4, "global_attn_block": 4},
})
# the int8 SAM encoder (phase 35): every block's gates of K1, K10, K3, K4
# and K8 closed on the int8 weights, so the 20 window layers take K6 and the
# 4 global ones K2 between the int8 products; SigLIP's 24 layers K3 / K4
EXPECTED_LAUNCHES["deepseek_vl_1_3b_int8_sam"] = {
    "window_block": 0, "sam_global_attention_v8": 4,
    "fused_ln_qkv": 24, "fused_proj_ln_mlp": 24,
    "sam_window_attention_v9": 20, "global_attn_block": 0,
    "fused_ln_mlp": 0}
WRAPPERS = e2e_bench.WRAPPERS  # every counted wrapper, by name
for _counts in EXPECTED_LAUNCHES.values():  # kernels not named: 0
    for _name in WRAPPERS:
        _counts.setdefault(_name, 0)
# the bench.py twin (phases 14-16): DeepSeek-VL-1.3B, bs 4, SAM-1024, S=672,
# with the global kernel knob at v11 and at its default
E2E_ITERS = 3
E2E_LAUNCHES = {
    "v11": {"window_block": 20, "sam_global_attention_v11": 4,
            "fused_ln_qkv": 28, "fused_proj_ln_mlp": 28},
    "v8": EXPECTED_LAUNCHES["deepseek_vl_1_3b"],
}
# the size sweep (phases 17-18): the two padded grids at bs 4; per forward the
# SigLIP tower's 24 layers and SAM's 24 go K3 / K4, SAM's 20 window layers K6
# and its 4 global layers K2 (at 640 the 1600-token grid is no multiple of
# 128: only v8 takes it)
SWEEP_SIZES, SWEEP_ITERS = (768, 640), 3
SWEEP_LAUNCHES = EXPECTED_LAUNCHES["deepseek_vl_1_3b_train_sam448"]
# the window-variant encoder (phase 19): SAM ViT-L at 768, bs 4
VARIANT_SAM = 768
# the family matrix (phases 20-21): (family, the caller's environment, preset,
# image tokens of the tower with its class token); each child, the
# int8_llm child too, times 1 forward a path after the bench's 2 warm-ups
FAMILY_POINTS = (
    ("llava", {"BENCH_GLOBAL_KERNEL": "v1"}, "1_5_7b", 577),
    ("hpt", {"BENCH_PRESET": "air", "BENCH_GLOBAL_KERNEL": "v4"}, "air", 785))
FAMILY_ITERS, FAMILY_TIMEOUT = 1, 600
NEW_GLOBALS = ("v1", "v2", "v4")
# the eval loop (phase 22): the eval scripts' defaults at DeepSeek-VL-1.3B,
# SAM-1024, over the synthetic sample stream; prompts are 583 tokens and 6
# a mask.  At SAM-768 one batch through each of these window kernels, of
# the first samples whose prompts fit the shortest bucket
EVAL_N, EVAL_SEED, EVAL_BS, EVAL_SEQ, EVAL_MASKS, EVAL_CAPTION = (
    32, 5, 8, 704, 8, 6)
EVAL_BUCKETS = (608, 640, 704)
EVAL_WINDOWS = NEW_WINDOWS + ("v9",)
EVAL_GT_MIN = 85.0  # cIoU and mIoU of the ground truth as +-8 logits
# the generation path (phase 24): DeepSeek-VL-1.3B with lm_head through the
# grounder API; two images of different aspect, (h, w); answers of up to 32
# new tokens (64 before PR 22).  Per call: the SigLIP tower at bs 1 (answer, the CoT's
# thought), at bs 2 (the CoT's two-image round) and the SAM ViT-L encoder
# at bs 1 (ground); the decoder's prefill and decode are plain
GEN_SEED, GEN_MAX_NEW = 9, 32
GEN_IMAGES = ((480, 640), (333, 500))
GEN_QUESTION = ("What is on the wooden table in this picture, and what "
                "colour is the small cup next to it?")
_TOWER = {"fused_ln_qkv": 24, "fused_proj_ln_mlp": 24}
_SAM_BS1 = {"window_block": 20, "sam_global_attention_v8": 4,
            "fused_ln_qkv": 4, "fused_proj_ln_mlp": 4}
_COT = {**_SAM_BS1, "fused_ln_qkv": 52, "fused_proj_ln_mlp": 52}
GEN_LAUNCHES = {"answer": _TOWER, "ground": _SAM_BS1, "visual_cot_v1": _COT,
                "visual_cot_v2": _COT}
# words of the stand-in tokenizer (ids 1000 up); any id decodes to one
GEN_WORDS = (
    "a the two some red blue green white black small large old wooden "
    "dog cat man woman hat cup table chair book car tree bird window road "
    "field bag plate bottle is are on in with and of near next to holding "
    "sitting standing there it . ,").split()
# files in, scores out (phase 25): DeepSeek-VL-1.3B, SAM ViT-L and
# released-layout head checkpoints written from a seed, the committed fixture
# tree (tests/data, made by tests/make_fixture_data.py), the eval CLIs at
# their defaults on the card
FILES_SEED = 11
# DeepSeek-VL-7B (phase 26): 2 requests at bs 4 after a warm-up, eager (the
# raw prompt layout, S = 672) and aligned (the image block at 128, S = 768,
# K5 in the 30 decoder layers); the trainer's steps at SAM-448, bs 8; then
# (phase 27) LLaVA-NeXT over Mistral-7B at phase 6's bs 2
HYBRID_SEED, HYBRID_REQUESTS = 12, 2
HYBRID_ALIGNED_START, HYBRID_ALIGNED_SEQ = 128, 768
HYBRID_TRAIN_STEPS = 3
HYBRID_STAGE_ITERS = 3  # the first forward of the split is a warm-up
STAGES = ("sam_b_trunk", "siglip", "projector", "decoder_capture",
          "sam_l_encoder", "heads")
FIXTURE = pathlib.Path(__file__).resolve().parent / "tests" / "data"
# the int8 slice (phase 35): what the host checks must find absent; the
# products at the main path's shapes (label, M, K, N): SAM ViT-L at
# SAM-1024 bs 4 (64 x 64 tokens an image), HPT-Air-1.5's Llama-3-8B at bs 4
# x S = 1280, and a decode step's 5 rows; the int8 SAM's bound on the mean
# |sigmoid difference| of the SAM logits (tests/test_quant.py's for the JAX
# int8 SAM); timed forwards a way
HOST_FORBIDDEN = ("jax", "jaxlib", "orbax", "tensorstore", "zstandard", "PIL")
INT8_SHAPES = (
    ("SAM ViT-L qkv", 16384, 1024, 3072), ("SAM ViT-L proj", 16384, 1024, 1024),
    ("SAM ViT-L mlp1", 16384, 1024, 4096), ("SAM ViT-L mlp2", 16384, 4096, 1024),
    ("Llama-3-8B q / o", 5120, 4096, 4096), ("Llama-3-8B k / v", 5120, 4096, 1024),
    ("Llama-3-8B gate / up", 5120, 4096, 14336),
    ("Llama-3-8B down", 5120, 14336, 4096),
    ("Llama-3-8B decode step q", 5, 4096, 4096))
INT8_SIGMOID_MAX, INT8_ITERS = 0.02, 3
FILES_GT_MIN = {"cIoU": 85.0, "AA": 0.85}  # AA is a fraction, cIoU percent
DECODE_REPEATS = 5
# phase 36: the parallel slice.  (c) two ranks on the one card at
# DeepSeek-VL-1.3B full width, bs 4, S = 672, each mode one forward, timed
# and checked after the one-rank reference has warmed the kernels; the
# launches a forward of each mode: tp keeps
# K3 (LN1 + the local qkv columns) and K6 / K2 on the local SAM heads, and
# the tower's K3 / K4; fsdp splits only the decoder (no kernel at this
# eager capture); the pipeline runs the decoder alone
PAR_BS, PAR_SEQ, PAR_SEED, PAR_RANKS = 4, 672, 16, 2
PAR_MODES = ("tp", "fsdp", "pipeline", "sp", "sp_aligned")
PAR_LAUNCHES = {
    "tp": {"fused_ln_qkv": 48, "fused_proj_ln_mlp": 24,
           "sam_window_attention_v9": 20, "sam_global_attention_v8": 4},
    "fsdp": EXPECTED_LAUNCHES["deepseek_vl_1_3b"],
    "pipeline": {}, "sp": {},
    "sp_aligned": {"flash_attention_with_merged_capture": 24}}
PAR_CORR = {"attn": 0.999, "hidden": 0.999, "last_hidden": 0.999,
            "sam_logits": 0.99, "lm_logits": 0.99}
PAR_TRAIN_STEPS = 3
# the sequence split (phase 36 (c) mode sp): the decoder alone over the
# "model" axis of the 1 x 2 mesh, at the phase's S = 672 (eager capture)
# and at DeepSeek-VL-1.3B with the image block at 128, S = 768 (K5 on each
# rank's 384 rows, 24 launches a rank); phase 3 also holds K5 at
# LLaVA-NeXT's rows 1664-3199, a 128-row boundary of S = 3200
SP_ALIGNED_START, SP_ALIGNED_SEQ, SP_ANYRES_FIRST_ROW = 128, 768, 1664
# phase 37: the measurement scripts at small sizes; the proxy's step budget
# and tail were chosen on the CPU (PERF.md section 7): the JAX script's
# heads learn by 200 steps, the port's by 120 (its weights are drawn on the
# host, so the card follows the CPU's trajectory)
MEASURE_OVERLAP = dict(preset="1_3b", batch_size=4, steps=3, workers=4)
MEASURE_PROXY_STEPS, MEASURE_PROXY_TAIL = 120, 24
MEASURE_PROXY_SIZES, MEASURE_PROXY_TIMEOUT = (1.0, 0.5), 600
# MGM (phases 28-32): Gemma-2B over CLIP-L/336 and ConvNeXt-L at 768, bs 4,
# the image block at 4 (S = 704 holds the longest prompt); Vicuna-7B HD at
# bs 2, the image block of 5 x 576 at 128, S = 3200 (ConvNeXt-L at 1536);
# the Mixtral-8x7B decoder cut to 4 layers; the grounder and files in,
# scores out at Gemma-2B
MGM_SEED, MGM_REQUESTS, MGM_SEQ = 13, 2, 704
MGM_HD_START, MGM_HD_BS, MGM_HD_SEQ = 128, 2, 3200
MGM_MOE_LAYERS = 4
MGM_GEN_SEED, MGM_GEN_MAX_NEW, MGM_FILES_SEED = 14, 32, 15
MGM_GAMMA = 0.1  # ConvNeXt's layer scale, a trained tower's order
MGM_STAGES = ("clip_tower", "convnext", "resampler_projector",
              "decoder_capture", "sam_l_encoder", "heads")
# the grounder's calls: the CLIP tower at bs 1 (answer) and bs 2 (the CoT's
# two-image round), SAM at bs 1 (ground)
MGM_GEN_LAUNCHES = {
    "answer": {"fused_ln_qkv": 23, "fused_proj_ln_mlp": 23},
    "ground": _SAM_BS1,
    "visual_cot_v1": {**_SAM_BS1, "fused_ln_qkv": 50,
                      "fused_proj_ln_mlp": 50}}
# training on real files (phase 33): the trainer CLI over the train layout
# of tests/data with its PNG narratives listed 4 times (79 samples, 9 bs-8
# batches an epoch), 1 warm-up and 3 timed steps a run; run (a) takes 11
# steps, so that its step 10, the first of epoch 1, is timed apart from the
# 9 after the warm-up inside an epoch; (e) is run (a) again with --profile
# 2, whose trace must name each kernel of the path by its __global__
# function: K1 / K3 / K4's GEMM core and row pass, K1 / K2's rel-pos
# attention core
TRAIN_REAL_STEPS, TRAIN_REAL_PROFILE = 4, 2
TRAIN_REAL_A_STEPS, TRAIN_REAL_PNG_REPEAT = 11, 4
TRAIN_REAL_TRACE_KERNELS = ("gemm_kernel", "ln_rows_kernel",
                            "relpos_sm90_kernel")
# the interactive slice (phase 34): phase 25's files through the SAM
# predictor, the automatic mask generator (32 x 32 points), the decoder
# export and the demo / Visual-CoT CLIs; the answers of the CLIs take 16 new
# tokens, the VisCoT JSON holds 2 items
INTERACTIVE_IMAGES = ("refcoco/train2014/COCO_train2014_000000000009.jpg",
                      "png/val2017/000000000285.jpg")
AMG_POINTS, EXPORT_MAX_TEXT, EXPORT_REL_ERR = 32, 16, 1e-4
INTERACTIVE_MAX_NEW, INTERACTIVE_SEED = 16, 16
INTERACTIVE_QUESTIONS = (GEN_QUESTION, "And what is next to it?")
COT_ITEMS = (
    {"image": [INTERACTIVE_IMAGES[0]], "conversations": [
        {"from": "human", "value": "<image>" + GEN_QUESTION},
        {"from": "gpt", "value": "a cup"}]},
    {"image": INTERACTIVE_IMAGES[1], "conversations": [
        {"from": "human", "value": "What is the man holding?"},
        {"from": "gpt", "value": "a bag"}]})


def family_launches(global_kernel: str) -> dict:
    """Per forward of LLaVA-1.5-7B and HPT-Air at SAM-1024: 23 CLIP-L layers
    (features at layer -2) and SAM's 4 global layers go K3 / K4, SAM's 20
    window layers K1, the 4 global attentions the named wrapper; the tower's
    attention is plain (``vision.flash`` is off in both presets) and the
    decoder captures eagerly (fewer than 1024 image tokens, image block not
    aligned)."""
    return {"window_block": 20, "fused_ln_qkv": 27, "fused_proj_ln_mlp": 27,
            GLOBAL_WRAPPER[global_kernel]: 4}


SOURCES = {
    "window_block": ("flmm_tpu_torch/ops/window_block.py",
                     "flmm_tpu/ops/window_block.py:293"),
    "sam_global_attention_v8": (
        "flmm_tpu_torch/csrc/relpos_attention_sm90.cu",
        "flmm_tpu/ops/sam_flash.py:292"),
    "fused_ln_qkv": ("flmm_tpu_torch/csrc/ln_gemm.cu",
                     "flmm_tpu/ops/fused_block.py:220"),
    "fused_proj_ln_mlp": ("flmm_tpu_torch/csrc/block_tail.cu",
                          "flmm_tpu/ops/fused_block.py:154"),
    "flash_attention_with_merged_capture": (
        "flmm_tpu_torch/csrc/flash_capture_sm90.cu",
        "flmm_tpu/ops/flash_attention.py:246"),
    "sam_window_attention_v9": (
        "flmm_tpu_torch/csrc/relpos_attention_sm90.cu",
        "flmm_tpu/ops/sam_flash.py:122"),
    "plain_flash_attention": ("flmm_tpu_torch/csrc/plain_flash.cu",
                              "flmm_tpu/ops/sam_flash.py:185"),
    "fused_ln_mlp": ("flmm_tpu_torch/csrc/block_tail.cu",
                     "flmm_tpu/ops/fused_block.py:264"),
    "global_attn_block": ("flmm_tpu_torch/ops/global_block.py",
                          "flmm_tpu/ops/global_block.py:243"),
    "flash_attention_with_capture": (
        "flmm_tpu_torch/csrc/flash_capture_sm90.cu",
        "flmm_tpu/ops/flash_attention.py:324"),
    "dewindowize": ("flmm_tpu_torch/csrc/boundary.cu",
                    "flmm_tpu/ops/boundary.py:59"),
    "windowize": ("flmm_tpu_torch/csrc/boundary.cu",
                  "flmm_tpu/ops/boundary.py:85"),
    "sam_window_attention_v10": (
        "flmm_tpu_torch/csrc/window_attention_sm90.cu",
        "flmm_tpu/ops/sam_flash_experiments.py:1222"),
    "sam_global_attention_v11": (
        "flmm_tpu_torch/csrc/relpos_attention_sm90.cu",
        "flmm_tpu/ops/sam_flash_experiments.py:1309"),
    "sam_global_attention_v3": (
        "flmm_tpu_torch/csrc/relpos_attention_sm90.cu",
        "flmm_tpu/ops/sam_flash_experiments.py:1046"),
    "sam_global_attention_v6": (
        "flmm_tpu_torch/csrc/relpos_attention_sm90.cu",
        "flmm_tpu/ops/sam_flash_experiments.py:942"),
    "sam_global_attention_v7": (
        "flmm_tpu_torch/csrc/relpos_attention_sm90.cu",
        "flmm_tpu/ops/sam_flash_experiments.py:981"),
    "sam_window_attention": (
        "flmm_tpu_torch/csrc/window_attention_sm90.cu",
                             "flmm_tpu/ops/sam_flash_experiments.py:695"),
    "sam_window_attention_v6": (
        "flmm_tpu_torch/csrc/window_attention_sm90.cu",
                                "flmm_tpu/ops/sam_flash_experiments.py:185"),
    "sam_window_attention_v7": (
        "flmm_tpu_torch/csrc/window_attention_sm90.cu",
                                "flmm_tpu/ops/sam_flash_experiments.py:270"),
    "sam_window_attention_v8": (
        "flmm_tpu_torch/csrc/window_attention_sm90.cu",
                                "flmm_tpu/ops/sam_flash_experiments.py:346"),
    "sam_global_attention": (
        "flmm_tpu_torch/csrc/relpos_attention_sm90.cu",
        "flmm_tpu/ops/sam_flash_experiments.py:1107"),
    "sam_global_attention_v2": (
        "flmm_tpu_torch/csrc/relpos_attention_sm90.cu",
        "flmm_tpu/ops/sam_flash_experiments.py:781"),
    "sam_global_attention_v4": (
        "flmm_tpu_torch/csrc/relpos_attention_sm90.cu",
        "flmm_tpu/ops/sam_flash_experiments.py:859"),
    "sam_window_attention_v2": (
        "flmm_tpu_torch/csrc/window_attention_sm90.cu",
                                "flmm_tpu/ops/sam_flash_experiments.py:422"),
    "sam_window_attention_v3": (
        "flmm_tpu_torch/csrc/window_attention_sm90.cu",
                                "flmm_tpu/ops/sam_flash_experiments.py:640"),
    "sam_window_attention_v4": (
        "flmm_tpu_torch/csrc/window_attention_sm90.cu",
                                "flmm_tpu/ops/sam_flash_experiments.py:545"),
    "sam_window_attention_v5": (
        "flmm_tpu_torch/csrc/window_attention_sm90.cu",
                                "flmm_tpu/ops/sam_flash_experiments.py:545"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls after
    one warm-up, from CUDA events.  A sleep kernel (about 25-30 ms) runs
    ahead of the start event, so the host has enqueued the calls before the
    first one starts: a wrapper whose host-side launch cost exceeds its
    kernel's time (a small window attention) reads its device time, not the
    host's."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


CAPTURE_KERNELS = ("flash_fwd", "merge_flags", "merged_capture",
                   "raw_capture")


def kernel_split_ms(fn, iters: int = 5) -> dict:
    """Device ms a call of ``fn`` of each capture kernel it launches (K5's
    and K9's passes; the wrapper's PyTorch ops summed apart), from the
    profiler's CUDA events over ``iters`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name == "Command Buffer Full":
            continue
        name = next((n + "_kernel" for n in CAPTURE_KERNELS if n in e.name),
                    "PyTorch ops in the wrapper")
        out[name] = out.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / iters
    return out


def capture_passes(entry: dict, name: str, label: str, fn, q, k, v,
                   merged: bool, causal_sdpa: bool = True) -> None:
    """Beside a K5 / K9 check: the merged output bit for bit across two
    runs (K5), each pass's device ms, and F.scaled_dot_product_attention
    with is_causal on the same q, k, v and every key valid, a yardstick for
    pass 1 alone (not the row's library call: no PyTorch call computes the
    capture, and the port never calls it); ``causal_sdpa=False`` for the
    rows of a sequence split, whose diagonal is_causal does not place."""
    if merged:
        first, second = fn()[1], fn()[1]
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"{name} [{label}]: the merged capture "
                                 "differs between two runs on one input")
        del first, second
    entry["pass_ms"] = kernel_split_ms(fn)
    yardstick = ""
    if causal_sdpa:
        gqa = k.shape[1] != q.shape[1]
        entry["sdpa_causal_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=gqa))
        yardstick = ("; sdpa causal (pass 1 yardstick, every key valid) "
                     f"{entry['sdpa_causal_ms']:.4f} ms")
    log(f"phase 3 {name} [{label}]: "
        + ("merged capture bit for bit equal across two runs; "
           if merged else "") + "passes " + ", ".join(
            f"{n} {ms:.4f} ms" for n, ms in entry["pass_ms"].items())
        + yardstick)


def agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want| / max |want|, correlation), after a finite check."""
    g, w = got.float().flatten(), want.float().flatten()
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError("non-finite values")
    rel = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
    corr = torch.corrcoef(torch.stack([g, w]))[0, 1].item()
    return rel, corr


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test needs a GPU")
    # the plain versions are the reference: full f32 products and convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # what the deterministic switch of phases 8-10 asks of cuBLAS, read when
    # its first handle is made; 8 x 4 MiB is also PyTorch's default on Hopper
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"phase 1 card: {card} ({torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda})")
    return card


def ptxas_summary(text: str) -> dict:
    """Per source of the build's ``ptxas.log``: its kernels' registers and
    the spill stores of those that spill, by mangled name."""
    out, src, entry = {}, None, None
    for line in text.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
            out[src] = {"registers": [], "spills": {}}
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "bytes spill stores" in line and src:
            stores = int(line.split("bytes spill stores")[0].split(",")[-1])
            if stores:
                out[src]["spills"][entry] = stores
        elif "Used" in line and "registers" in line and src:
            out[src]["registers"].append(
                int(line.split("Used")[1].split("registers")[0]))
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    _cuda.library()
    log(f"phase 2 build: kernel library ready in "
        f"{time.perf_counter() - t0:.1f} s")
    log_path = _cuda.BUILD / "ptxas.log"
    if log_path.exists():  # absent when an earlier run built the library
        for src, r in ptxas_summary(log_path.read_text()).items():
            regs = r["registers"]
            log(f"phase 2 ptxas {src}: {len(regs)} kernels, "
                f"{min(regs, default=0)}-{max(regs, default=0)} registers; "
                f"spill stores {r['spills'] or 'none'}")


def _randn(g, shape, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale
            + shift).to(torch.bfloat16)


def anyres_batches(cfg, device=None) -> list:
    """The warm-up batch and 3 distinct requests of the LLaVA-NeXT phase
    (numpy, or tensors on ``device``)."""
    out = []
    for seed in range(4):
        b = synthetic_anyres_batch(cfg, ANYRES_SIZES,
                                   prompt_len=ANYRES_PROMPT,
                                   max_masks=MASKS, caption_tokens=TEXT,
                                   seed=seed)
        out.append(b if device is None else from_jax(b, device))
    return out


def _tensor_bytes(*items) -> int:
    return sum(t.numel() * t.element_size() for t in items
               if isinstance(t, torch.Tensor))


def _attention_mask(q, rel_pos_h, rel_pos_w, side: int) -> torch.Tensor:
    """The decomposed rel-pos bias of ``(G, S, hd)`` heads expanded to an
    additive ``(1, G, S, S)`` mask in natural base, for the library call's
    timing only."""
    rows = sam_flash.global_bias_rows(q, rel_pos_h, rel_pos_w, side)
    G, S, _ = rows.shape
    mask = torch.empty((1, G, S, S), dtype=q.dtype, device=q.device)
    for g0 in range(0, G, 8):  # the f32 sum of 8 heads at a time
        r = rows[g0:g0 + 8].float() * sam_flash.LN2
        mask[0, g0:g0 + 8] = (r[..., :side, None] + r[..., None, side:]
                              ).reshape(-1, S, S)
    return mask


def _sdpa(q, k, v, mask=None):
    """``F.scaled_dot_product_attention`` over ``(G, S, hd)`` heads or ``(B,
    H, S, hd)`` views: the yardstick of K2, K6 and K7, called nowhere in the
    port."""
    if q.dim() == 3:
        q, k, v = q[None], k[None], v[None]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)


def hpt_switches(cfg):
    """The two kernel switches a user sets on top of an HPT preset: the
    tower's flash attention (K7) and the whole-block global SAM layer (K10
    + K8)."""
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, flash=True),
        sam=dataclasses.replace(cfg.sam, encoder=dataclasses.replace(
            cfg.sam.encoder, global_block_fused=True)))


def hpt_config():
    """HPT-Air-1.5 with the image block at 128 and :func:`hpt_switches`."""
    return hpt_switches(registry.get_config("hpt", "air_1_5",
                                            img_start=HPT_IMG_START))


def hpt_batches(cfg, n: int, device=None) -> list:
    """``n`` distinct bs-4 requests of the HPT-Air-1.5 phase (numpy, or
    tensors on ``device``)."""
    out = []
    for seed in range(n):
        b = synthetic_batch(cfg, batch_size=BS, seq_len=HPT_SEQ,
                            max_masks=MASKS, text_tokens_per_mask=TEXT,
                            seed=seed)
        out.append(b if device is None else from_jax(b, device))
    return out


def dense_mask_ids(batch: dict, n_masks: int, text_start: int) -> np.ndarray:
    """``n_masks`` masks over the valid rows from ``text_start`` on (the
    caption after the image block), in runs of consecutive rows, each
    mask at least one row: a dense narrative's spans."""
    ids = np.full(batch["mask_ids"].shape, -1, np.int32)
    for b, valid in enumerate(batch["attn_mask"]):
        rows = np.flatnonzero(valid[text_start:]) + text_start
        if len(rows) < n_masks:
            raise AssertionError(f"{len(rows)} caption rows for {n_masks} "
                                 "masks")
        ids[b, rows] = np.arange(len(rows)) * n_masks // len(rows)
    return ids


def check_capture(check, gen: torch.Generator, label: str, batch: dict,
                  H: int, KV: int, img_start: int, n_img: int,
                  first_row: int = 0, n_masks: int = MASKS) -> None:
    """K5 at one decoder layer of a serving path that captures through it,
    with the path's key holes and merge matrix (``batch``, numpy); q, k, v
    as (B, H, S, hd) views of the decoder's (B, S, H, hd) projections.
    ``first_row``: q holds only the rows ``[first_row, S)`` of one rank of
    a sequence split (``q_offset``), against all S keys.  At ``n_masks``
    other than the batch's ``MASKS``, the masks cover the caption rows
    densely (``dense_mask_ids``), every column of the merge matrix in
    use."""
    valid = torch.from_numpy(batch["attn_mask"]).cuda()
    ids = (batch["mask_ids"] if n_masks == MASKS else
           dense_mask_ids(batch, n_masks, img_start + n_img))
    mm = masks.mean_merge_matrix(torch.from_numpy(ids).cuda(),
                                 n_masks)[:, first_row:]
    if n_masks != MASKS and not bool((mm != 0).any(dim=1).all()):
        raise AssertionError(f"{label}: a mask without a caption row")
    B, S = valid.shape
    hd = 128
    q = _randn(gen, (B, S - first_row, H, hd)).transpose(1, 2)
    k, v = (_randn(gen, (B, S, KV, hd)).transpose(1, 2) for _ in range(2))
    # what this batch needs: 4 * hd FLOP per visible (query, key) pair
    # and head, and the merge of its text rows' image-block
    # probabilities, 2 * M * n_img FLOP per row and head
    pairs = int(valid.cumsum(1)[:, first_row:].sum())
    text_rows = int((mm != 0).any(dim=-1).sum())
    label = (f"{label}: B={B}, H={H}, KV={KV}, S={S}, n_img={n_img}, "
             f"M={n_masks}" + (f", rows {first_row}-{S - 1}" if first_row
                               else ""))
    args = (q, k, v, valid, mm, img_start, n_img, first_row)
    entry = check("flash_attention_with_merged_capture", label,
                  flash_attention.flash_attention_with_merged_capture,
                  flash_attention.flash_attention_with_merged_capture_plain,
                  args, rel_bounds=(KERNEL_REL_ERR, MERGED_REL_ERR),
                  flop=4 * H * hd * pairs
                  + 2 * H * n_masks * n_img * text_rows)
    capture_passes(
        entry, "flash_attention_with_merged_capture", label,
        lambda: flash_attention.flash_attention_with_merged_capture(
            *args), q, k, v, merged=True, causal_sdpa=not first_row)


def make_check(results: dict):
    """The phase-3 check of one kernel at one shape, recording into
    ``results`` by kernel name."""
    def check(name, label, wrapper, plain, args, flop, library_fn=None,
              library_view=None, moved=None, exact=False, rel_bounds=None):
        """Compare, time and bound one kernel: ``flop`` is the operations of
        its products at this shape, the bytes are those of its operands and
        results, each moved once (``moved`` where the function reads less
        than its whole input).  ``exact`` asks for bit-equal results;
        ``rel_bounds`` gives each output a max rel err bound of its own
        (else ``KERNEL_REL_ERR``); ``library_view`` brings the library
        call's result into the kernel's layout for the comparison, outside
        the timing.  Returns the shape's entry of ``results``."""
        def kernel_fn():
            return wrapper(*args)

        def plain_fn():
            return plain(*args)

        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        pairs = ([(a, b) for a, b in zip(got, want)
                  if isinstance(a, torch.Tensor)] if isinstance(got, tuple)
                 else [(got, want)])
        rels, corrs = zip(*(agreement(a, b) for a, b in pairs))
        rel, corr = max(rels), min(corrs)
        bounds = rel_bounds or (KERNEL_REL_ERR,) * len(rels)
        same = all(torch.equal(a, b) for a, b in pairs) if exact else None
        if moved is None:
            moved = _tensor_bytes(*args, *(a for a, _ in pairs))
        del want
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        library_ms = None
        if library_fn is not None:
            lib_out = library_fn()
            lib_rel, _ = agreement(
                library_view(lib_out) if library_view is not None
                else lib_out.reshape(pairs[0][0].shape), pairs[0][0])
            del lib_out
            library_ms = cuda_ms(library_fn)
        by_ops, by_bytes = flop / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
        bound_ms = max(by_ops, by_bytes)
        ok = (all(r <= b for r, b in zip(rels, bounds))
              and corr >= KERNEL_CORR and same is not False)
        library = ("none" if library_ms is None else
                   f"{library_ms:.3f} ms (kernel vs library max_rel_err "
                   f"{lib_rel:.3e})")
        errs = (f"max_rel_err {rel:.3e} (bound {KERNEL_REL_ERR})"
                if rel_bounds is None else "max_rel_err " + ", ".join(
                    f"{r:.3e} (bound {b})" for r, b in zip(rels, bounds)))
        log(f"phase 3 {name} [{label}]: {errs} corr {corr:.6f} (bound "
            f"{KERNEL_CORR}) "
            + (f"bit for bit equal: {same} " if exact else "") +
            f"kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s) plain "
            f"{plain_ms:.3f} ms library {library}; {flop / 1e9:.1f} GFLOP, "
            f"{moved / 1e6:.1f} MB, least {bound_ms:.4f} ms")
        if not ok:
            raise AssertionError(f"{name} [{label}] disagrees with its "
                                 "plain version")
        entry = {
            "shape": label, "max_abs_err": max(
                (a.float() - b.float()).abs().max().item() for a, b in pairs),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": library_ms}
        if name not in results:  # the first shape listed leads the entry
            results[name] = {**entry, "other_shapes": []}
            return results[name]
        results[name]["other_shapes"].append(entry)
        return entry

    return check


def phase_kernels(g: torch.Generator, g_hpt: torch.Generator,
                  g_bench: torch.Generator, g_e2e: torch.Generator,
                  g_sweep: torch.Generator) -> dict:
    """Each kernel against its plain version at the main paths' shapes.
    The checks that came with the HPT path draw from ``g_hpt``, those that
    came with the kernel bench from ``g_bench``, those of the global
    variants from ``g_e2e`` and those of the window variants and the size
    sweep from ``g_sweep``, so that the earlier paths keep the weights and
    inputs ``g`` and ``g_hpt`` have always given them (phase 9's U-Net
    gradient comparison is sensitive to the state the training steps
    reach)."""
    C, F, hd = 1024, 4096, 64
    results = {}
    check = make_check(results)

    def ln_params(gen=g):
        return _randn(gen, (C,), 0.1, 1.0), _randn(gen, (C,), 0.1)

    # K3 / K4 / K8: SAM global layers (N = 4096 * bs); K3 / K4 also at the
    # SigLIP layers (576 * bs), the CLIP-L/336 layers over base + 4 tile
    # slots (577 * 5 * 2, quick_gelu) and the SAM-448 training rows
    train_grid = TRAIN_SAM // 16
    for label, N, act, eps in (
            ("SAM global, N=16384", 4096 * BS, "gelu", 1e-6),
            ("SigLIP, N=2304", 576 * BS, "gelu", 1e-6),
            ("CLIP, N=5770, quick_gelu", 577 * 5 * ANYRES_BS, "quick_gelu",
             1e-5),
            ("SAM-448 training, N=6272", train_grid ** 2 * TRAIN_BS, "gelu",
             1e-6)):
        x, a = _randn(g, (N, C)), _randn(g, (N, C))
        lw, lb = ln_params()
        wqkv, bqkv = _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), .1)
        wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
        w1, b1 = _randn(g, (C, F), C ** -0.5), _randn(g, (F,), 0.1)
        w2, b2 = _randn(g, (F, C), F ** -0.5), _randn(g, (C,), 0.1)
        check("fused_ln_qkv", label, fused_block.fused_ln_qkv,
              fused_block.fused_ln_qkv_plain, (x, lw, lb, wqkv, bqkv, eps),
              flop=2 * N * C * 3 * C)
        check("fused_proj_ln_mlp", label, fused_block.fused_proj_ln_mlp,
              fused_block.fused_proj_ln_mlp_plain,
              (x, a, wo, bo, lw, lb, w1, b1, w2, b2, eps, act),
              flop=2 * N * C * C + 4 * N * C * F)
        if N == 4096 * BS:
            check("fused_ln_mlp", label, fused_block.fused_ln_mlp,
                  fused_block.fused_ln_mlp_plain,
                  (x, lw, lb, w1, b1, w2, b2, eps, act), flop=4 * N * C * F)

    # K2: 4 images x 16 heads over the 64 x 64 grid; each (query, key) pair
    # of a head is 2 products of 2 * hd FLOP
    side = 64
    q, k, v = (_randn(g, (16 * BS, side * side, hd)) for _ in range(3))
    rph, rpw = _randn(g, (2 * side - 1, hd), 0.1), _randn(g, (2 * side - 1, hd), 0.1)
    mask = _attention_mask(q, rph, rpw, side)  # 2.1 GB, outside the timing
    check("sam_global_attention_v8", "G=64, S=4096",
          sam_flash.sam_global_attention_v8,
          sam_flash.sam_global_attention_v8_plain, (q, k, v, rph, rpw, side),
          flop=4 * 16 * BS * side ** 4 * hd,
          library_fn=lambda: _sdpa(q, k, v, mask))
    del mask

    # K10: the attention half of a global block over the same grid, from
    # the residual stream, with non-zero rel-pos tables; its f32 result is
    # compared as f32 and must repeat bit for bit
    nh = 16
    S = side * side
    x = _randn(g_hpt, (BS, S, C))
    lw, lb = ln_params(g_hpt)
    w_s, b_s = window_block.scaled_qkv_weights(
        _randn(g_hpt, (C, 3 * C), C ** -0.5), _randn(g_hpt, (3 * C,), 0.1),
        nh, hd)
    wo, bo = _randn(g_hpt, (C, C), C ** -0.5), _randn(g_hpt, (C,), 0.1)
    bias = global_block.global_rel_bias_from_x(
        x, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, side, nh, hd)
    args = (x, bias, lw, lb, w_s, b_s, wo, bo, side, nh)
    check("global_attn_block", f"B={BS}, S={S}, C={C}, f32 result",
          global_block.global_attn_block,
          global_block.global_attn_block_plain, args,
          flop=2 * BS * S * C * 3 * C + 4 * BS * nh * S * S * hd
          + 2 * BS * S * C * C)
    first, second = (global_block.global_attn_block(*args) for _ in range(2))
    torch.cuda.synchronize()
    if first.dtype != torch.float32 or not torch.equal(first, second):
        raise AssertionError("global_attn_block: the result is not f32 or "
                             "differs between two runs on one input")
    log("phase 3 global_attn_block: f32 result, bit for bit equal across "
        "two runs")
    del first, second, bias, args

    # K1: the 64 x 64 grid padded to 70 x 70 = 25 windows per image
    ws = 14
    x = _randn(g, (BS, 64, 64, C))
    xw, geom = sam_encoder._windowize(x, ws)
    xw = xw.contiguous()
    valid = sam_encoder._window_valid_tokens(geom, ws, x.device)
    lw, lb = ln_params()
    l2w, l2b = ln_params()
    w_s, b_s = window_block.scaled_qkv_weights(
        _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), 0.1), nh, hd)
    wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
    w1, b1 = _randn(g, (C, F), C ** -0.5), _randn(g, (F,), 0.1)
    w2, b2 = _randn(g, (F, C), F ** -0.5), _randn(g, (C,), 0.1)
    rph, rpw = _randn(g, (2 * ws - 1, hd), 0.1), _randn(g, (2 * ws - 1, hd), 0.1)
    bias = window_block.window_rel_bias_from_x(
        xw, valid, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, ws, nh, hd)
    NW, T = xw.shape[:2]
    check("window_block", f"NW={NW}, T=196, padded grid",
          window_block.window_block, window_block.window_block_plain,
          (xw, bias, valid, lw, lb, w_s, b_s, wo, bo, l2w, l2b, w1, b1, w2,
           b2, ws, nh),
          flop=NW * T * (2 * C * 3 * C + 2 * C * C + 4 * C * F)
          + 4 * NW * nh * T * T * hd)

    # K5: one decoder layer of each serving path that captures through it
    anyres = anyres_batches(
        llava_next.llava_next_vicuna_7b(img_start=ANYRES_IMG_START))[0]
    hpt = hpt_batches(hpt_config(), 1)[0]
    check_capture(check, g, "LLaVA-NeXT", anyres, 32, 32, ANYRES_IMG_START,
                  2928)
    check_capture(check, g_hpt, "HPT-Air-1.5", hpt, 32, 8, HPT_IMG_START,
                  1024)
    # K5 on one rank's query rows of a sequence split (q_offset): the sp
    # shape of phase 36 (c) and LLaVA-NeXT's at a 128-row boundary
    check_capture(check, g, "sp DeepSeek-VL-1.3B aligned", synthetic_batch(
        deepseek_vl.deepseek_vl_1_3b(img_start=SP_ALIGNED_START),
        batch_size=BS, seq_len=SP_ALIGNED_SEQ, max_masks=MASKS,
        text_tokens_per_mask=TEXT, seed=0), 16, 16, SP_ALIGNED_START, 576,
        first_row=SP_ALIGNED_SEQ // PAR_RANKS)
    check_capture(check, g, "sp LLaVA-NeXT", anyres, 32, 32,
                  ANYRES_IMG_START, 2928, first_row=SP_ANYRES_FIRST_ROW)
    # K5 above 32 masks (chunks of 32 in the merged pass), drawn from their
    # own generator so that the rows above keep their inputs
    g_masks = torch.Generator(device="cuda").manual_seed(17)
    for n_masks in WIDE_MASKS:
        check_capture(check, g_masks, "LLaVA-NeXT", anyres, 32, 32,
                      ANYRES_IMG_START, 2928, n_masks=n_masks)
    check_capture(check, g_masks, "HPT-Air-1.5", hpt, 32, 8, HPT_IMG_START,
                  1024, n_masks=WIDE_MASKS[0])
    check_capture(check, g_masks, "sp LLaVA-NeXT", anyres, 32, 32,
                  ANYRES_IMG_START, 2928, first_row=SP_ANYRES_FIRST_ROW,
                  n_masks=WIDE_MASKS[0])

    # K2 over the SAM-448 grid: 8 images x 16 heads, side 28 (S = 784)
    hd = 64
    q, k, v = (_randn(g, (16 * TRAIN_BS, train_grid ** 2, hd))
               for _ in range(3))
    rph, rpw = (_randn(g, (2 * train_grid - 1, hd), 0.1) for _ in range(2))
    mask = _attention_mask(q, rph, rpw, train_grid)  # outside the timing
    check("sam_global_attention_v8", "SAM-448, G=128, S=784",
          sam_flash.sam_global_attention_v8,
          sam_flash.sam_global_attention_v8_plain,
          (q, k, v, rph, rpw, train_grid),
          flop=4 * 16 * TRAIN_BS * train_grid ** 4 * hd,
          library_fn=lambda: _sdpa(q, k, v, mask))

    # K6: the 2 x 2 windows of 14 x 14 of 8 SAM-448 images, 16 heads, read
    # as (NW, nh, T, hd) views of the windowised qkv as the encoder passes
    # them: G = 512 window-heads, T = 196
    NW, T = 4 * TRAIN_BS, ws * ws
    qkvw = _randn(g, (NW, T, 3 * C))
    heads = [qkvw[..., i * C:(i + 1) * C].reshape(NW, T, nh, hd).transpose(
        1, 2) for i in range(3)]
    rph, rpw = (_randn(g, (2 * ws - 1, hd), 0.1) for _ in range(2))
    mask = _attention_mask(heads[0].reshape(NW * nh, T, hd), rph, rpw,
                           ws).reshape(NW, nh, T, T)
    check("sam_window_attention_v9", f"G={NW * nh}, T={T}, (NW, nh, T, hd) "
          "views", sam_flash.sam_window_attention_v9,
          sam_flash.sam_window_attention_v9_plain, (*heads, rph, rpw, ws),
          flop=4 * NW * nh * T * T * hd,
          library_fn=lambda: _sdpa(*heads, mask))

    # K7: the SigLIP-SO400M/448 tower's attention, 4 images x 16 heads of 72
    # over 1024 tokens, as (B, H, S, hd) views of a layer's qkv rows; then
    # the CLIP-L/336 shape, contiguous heads of 64 over S = 577
    H, hd, S = 16, 72, 1024
    qkv = _randn(g_hpt, (BS, S, 3 * H * hd))
    heads = [t.reshape(BS, S, H, hd).transpose(1, 2)
             for t in qkv.split(H * hd, dim=-1)]
    check("plain_flash_attention", f"G={BS * H}, S={S}, hd={hd}, (B, H, S, "
          "hd) views", sam_flash.plain_flash_attention,
          sam_flash.plain_flash_attention_plain, heads,
          flop=4 * BS * H * S * S * hd, library_fn=lambda: _sdpa(*heads))
    q, k, v = (_randn(g_hpt, (BS * H, 577, 64)) for _ in range(3))
    check("plain_flash_attention", f"G={BS * H}, S=577, hd=64",
          sam_flash.plain_flash_attention,
          sam_flash.plain_flash_attention_plain, (q, k, v),
          flop=4 * BS * H * 577 * 577 * 64, library_fn=lambda: _sdpa(q, k, v))
    # the odd S at both head widths, as (B, H, S, hd) views of qkv rows (the
    # CLIP-L towers at hd 64; hd 72 past a 64-key tile's end)
    for hd_v in (72, 64):
        qkv = _randn(g_hpt, (BS, 577, 3 * H * hd_v))
        heads = [t.reshape(BS, 577, H, hd_v).transpose(1, 2)
                 for t in qkv.split(H * hd_v, dim=-1)]
        check("plain_flash_attention", f"G={BS * H}, S=577, hd={hd_v}, (B, "
              "H, S, hd) views", sam_flash.plain_flash_attention,
              sam_flash.plain_flash_attention_plain, heads,
              flop=4 * BS * H * 577 * 577 * hd_v,
              library_fn=lambda: _sdpa(*heads))
    del q, k, v, qkv, heads, mask
    kernel_bench_checks(check, g_bench)
    bench_shape_checks(check, g_bench)
    global_variant_checks(check, g_e2e)
    window_variant_checks(check, g_sweep)
    sweep_shape_checks(check, g_sweep)
    family_shape_checks(check, g_sweep)
    sm90_checks(check, results, torch.Generator(device="cuda").manual_seed(6))
    side_checks(check, torch.Generator(device="cuda").manual_seed(7))
    generation_shape_checks(check,
                            torch.Generator(device="cuda").manual_seed(8))
    hybrid_shape_checks(check, torch.Generator(device="cuda").manual_seed(10))
    mgm_shape_checks(check, torch.Generator(device="cuda").manual_seed(16))
    return results


def mgm_shape_checks(check, g: torch.Generator) -> None:
    """Phase 3 for the MGM paths (phases 28-32): K5 at the HD decoder layer,
    Vicuna-7B's 32 heads of 128 (MHA) over S = 3200 with the image block of
    2880 at 128 (padded to 2944) and no key holes.  Their K1-K4 shapes are
    the LLaVA paths': CLIP-L/336 rows of 4 x 577 (Gemma-2B, bs 4) and 2 x
    5 x 577 (HD, bs 2, the 5 crops in one batch), SAM ViT-L at 1024."""
    cfg = mgm_configs.mgm_vicuna_7b_hd(img_start=MGM_HD_START)
    batch = e2e_bench.samples_batch(cfg, "mgm", MGM_HD_BS, MGM_HD_SEQ)
    valid = batch["attn_mask"]
    n = valid.sum(1, keepdims=True)
    if valid.shape[1] != MGM_HD_SEQ or not (
            valid == (np.arange(MGM_HD_SEQ) < n)).all():
        raise AssertionError("MGM-HD batch: not S = 3200 with each prompt "
                             "a prefix (no key holes)")
    check_capture(check, g, "MGM-Vicuna-7B-HD", batch, 32, 32,
                  MGM_HD_START, cfg.base.num_img_tokens)


def hybrid_shape_checks(check, g: torch.Generator) -> None:
    """Phase 3 for the DeepSeek-VL-7B path (phase 26): K5 at its aligned
    decoder layer, 32 heads of 128 (MHA) over S = 768 with the image block
    of 576 at 128.  Its K1-K4 shapes are the 1.3B path's: the SigLIP tower
    and SAM ViT-L are the same at bs 4, and the SAM-B trunk runs plain."""
    batch = synthetic_batch(
        deepseek_vl.deepseek_vl_7b(img_start=HYBRID_ALIGNED_START),
        batch_size=BS, seq_len=HYBRID_ALIGNED_SEQ, max_masks=MASKS,
        text_tokens_per_mask=TEXT, seed=0)
    check_capture(check, g, "DeepSeek-VL-7B aligned", batch, 32, 32,
                  HYBRID_ALIGNED_START, 576)


def kernel_bench_checks(check, g: torch.Generator) -> None:
    """Phase 3 for the kernels that came with the kernel bench: K9, K11a,
    K11b and K12 v10."""
    # K9: raw capture at the DeepSeek-VL-1.3B aligned decoder layout (S = 768,
    # the 576-token image block at 128) and at the HPT layout (GQA 32/8, S =
    # 1280, 1024 image tokens); k and v carry the kv heads, as views of the
    # decoder's (B, S, KV, hd) projections.  What the batch needs: 4 * hd FLOP
    # per visible (query, key) pair and head; the probabilities are a
    # by-product of those scores
    hd = 128
    for label, H, KV, S, n_img, lengths in (
            ("DeepSeek-VL-1.3B aligned", 16, 16, 768, 576,
             [768, 700, 640, 768]),
            ("HPT-Air-1.5", 32, 8, HPT_SEQ, 1024, [1280, 1200, 900, 1280])):
        q = _randn(g, (BS, S, H, hd)).transpose(1, 2)
        k, v = (_randn(g, (BS, S, KV, hd)).transpose(1, 2) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        pairs = sum(min(i + 1, n) for n in lengths for i in range(S))
        label = (f"{label}: B={BS}, H={H}, KV={KV}, S={S}, img_start=128, "
                 f"n_img={n_img}, lengths={lengths}")
        entry = check("flash_attention_with_capture", label,
                      flash_attention.flash_attention_with_capture,
                      flash_attention.flash_attention_with_capture_plain,
                      (q, k, v, lens, 128, n_img), flop=4 * H * hd * pairs)
        capture_passes(
            entry, "flash_attention_with_capture", label,
            lambda: flash_attention.flash_attention_with_capture(
                q, k, v, lens, 128, n_img), q, k, v, merged=False)
    del q, k, v

    # K11: the relayout pair at the SAM-1024 grid (64 x 64 tokens of 1024
    # channels in 5 x 5 windows of 14), bs 8 as the bench runs it, bs 4 as a
    # serving forward would, and once in f32.  A copy does no operation; the
    # pad slots are written, not read, and dewindowize reads valid tokens only
    ws, C = 14, 1024
    for bs, dtype in ((BENCH_BS, torch.bfloat16), (BS, torch.bfloat16),
                      (BS, torch.float32)):
        x = _randn(g, (bs, 64, 64, C)).to(dtype)
        xw, geom = boundary.windowize_plain(x, ws)
        label = f"B={bs}, 64 x 64 x {C}, ws={ws}, {str(dtype)[6:]}"
        check("dewindowize", label, boundary.dewindowize,
              lambda *a: boundary.dewindowize_plain(*a).contiguous(),
              (xw, geom, ws), flop=0, exact=True, moved=2 * _tensor_bytes(x))
        check("windowize", label, boundary.windowize, boundary.windowize_plain,
              (x, ws), flop=0, exact=True)
    del x, xw

    # K12 v10: the bs-8 grid padded to 70 x 70, head-major qkv that is zero
    # beyond 64, non-zero tables.  What the data needs: 4 * hd FLOP per
    # (query, key) pair of valid tokens, window by window and head by head
    side, grid_hw, nh, hd = 14, 64, 16, 64
    Hp = -(-grid_hw // side) * side
    nw, T = Hp // side, side * side
    qkv = torch.nn.functional.pad(
        _randn(g, (BENCH_BS, grid_hw, grid_hw, nh * 3 * hd), 0.3),
        (0, 0, 0, Hp - grid_hw, 0, Hp - grid_hw))
    rph, rpw = (_randn(g, (2 * side - 1, hd), 0.1) for _ in range(2))
    inside = torch.arange(Hp, device="cuda") < grid_hw
    valid = inside[:, None] & inside[None, :]  # (Hp, Wp)
    per_window = valid.reshape(nw, side, nw, side).sum(dim=(1, 3))
    pairs = int((per_window ** 2).sum()) * BENCH_BS * nh
    # the library call: SDPA over the windowised heads with the expanded bias
    # and the key mask as one additive mask, all built outside the timing
    heads = qkv.reshape(BENCH_BS, nw, side, nw, side, nh, 3, hd).permute(
        6, 0, 1, 3, 5, 2, 4, 7).reshape(3, BENCH_BS * nw * nw, nh, T, hd)
    heads = [t.contiguous() for t in heads]
    mask = _attention_mask(heads[0].reshape(-1, T, hd), rph, rpw, side)
    key_ok = valid.reshape(nw, side, nw, side).permute(0, 2, 1, 3).reshape(
        1, nw * nw, 1, 1, T).expand(BENCH_BS, nw * nw, nh, 1, T)
    mask = mask.reshape(-1, nh, T, T).masked_fill(
        ~key_ok.reshape(-1, nh, 1, T), float("-inf"))

    def spatial(out):  # (NW, nh, T, hd) -> (B, Hp, Wp, C), 0 beyond the grid
        out = out.reshape(BENCH_BS, nw, nw, nh, side, side, hd).permute(
            0, 1, 4, 2, 5, 3, 6).reshape(BENCH_BS, Hp, Hp, nh * hd)
        return torch.where(valid[None, :, :, None], out, 0.0)

    # the bytes the function needs: the valid tokens' qkv read and their
    # output written, and the tables (the pad holds nothing to read, and its
    # zero output is this port's own choice)
    moved = (BENCH_BS * grid_hw * grid_hw * nh * 4 * hd * qkv.element_size()
             + _tensor_bytes(rph, rpw))
    check("sam_window_attention_v10",
          f"B={BENCH_BS}, {Hp} x {Hp} x {nh * 3 * hd}, side={side}, "
          f"grid_hw={grid_hw}",
          sam_flash_experiments.sam_window_attention_v10,
          sam_flash_experiments.sam_window_attention_v10_plain,
          (qkv, rph, rpw, side, grid_hw), flop=4 * hd * pairs,
          library_fn=lambda: _sdpa(*heads, mask), library_view=spatial,
          moved=moved)
    # the wrapper runs no plain preparation: its time beside the kernel's
    sfx = sam_flash_experiments
    tables = sam_flash.kernel_tables("v10", rph, rpw, side,
                                     sfx.MAX_WINDOW_SIDE)
    out = torch.empty((BENCH_BS, Hp, Hp, nh * hd), dtype=qkv.dtype,
                      device="cuda")
    wrapper_ms = cuda_ms(lambda: sfx.sam_window_attention_v10(
        qkv, rph, rpw, side, grid_hw))
    alone_ms = cuda_ms(lambda: sfx.spatial_window_attention_sm90(
        qkv, tables, side, grid_hw, out))
    log(f"phase 3 sam_window_attention_v10: wrapper {wrapper_ms:.3f} ms, "
        f"kernel alone {alone_ms:.3f} ms; plain preparation on the kernel "
        "path: none")


def bench_shape_checks(check, g: torch.Generator) -> None:
    """Phase 3 at the shapes the kernel bench (phase 13) gives the kernels of
    the earlier paths, which the checks above hold at bs 4 or at SAM-448
    only: bs 8 at the SAM-1024 grid, the SigLIP-L/384 tower and the
    DeepSeek-LLM-1.3B decoder's aligned layout."""
    C, F, hd, nh, ws, side, B = 1024, 4096, 64, 16, 14, 64, BENCH_BS
    S = side * side

    def ln_params():
        return _randn(g, (C,), 0.1, 1.0), _randn(g, (C,), 0.1)

    lw, lb = ln_params()
    l2w, l2b = ln_params()
    wqkv, bqkv = _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), 0.1)
    wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
    w1, b1 = _randn(g, (C, F), C ** -0.5), _randn(g, (F,), 0.1)
    w2, b2 = _randn(g, (F, C), F ** -0.5), _randn(g, (C,), 0.1)
    w_s, b_s = window_block.scaled_qkv_weights(wqkv, bqkv, nh, hd)

    # K3 / K4: the unpadded token rows of wb, gb, encoder and heads (the
    # flash window path pads after K3 and crops before K4), and the tower's
    # rows; K8: the rows of gb
    for label, N in ((f"bench SAM rows, N={S * B}", S * B),
                     (f"bench SigLIP, N={576 * B}", 576 * B)):
        x, a = _randn(g, (N, C)), _randn(g, (N, C))
        check("fused_ln_qkv", label, fused_block.fused_ln_qkv,
              fused_block.fused_ln_qkv_plain, (x, lw, lb, wqkv, bqkv, 1e-6),
              flop=2 * N * C * 3 * C)
        check("fused_proj_ln_mlp", label, fused_block.fused_proj_ln_mlp,
              fused_block.fused_proj_ln_mlp_plain,
              (x, a, wo, bo, lw, lb, w1, b1, w2, b2, 1e-6, "gelu"),
              flop=2 * N * C * C + 4 * N * C * F)
        if N == S * B:
            check("fused_ln_mlp", label, fused_block.fused_ln_mlp,
                  fused_block.fused_ln_mlp_plain,
                  (x, lw, lb, w1, b1, w2, b2, 1e-6, "gelu"),
                  flop=4 * N * C * F)
    del x, a

    # K2: global, gb, encoder and heads: 8 images x 16 heads, contiguous
    q, k, v = (_randn(g, (nh * B, S, hd)) for _ in range(3))
    rph, rpw = (_randn(g, (2 * side - 1, hd), 0.1) for _ in range(2))
    mask = _attention_mask(q, rph, rpw, side)  # 4.3 GB, outside the timing
    check("sam_global_attention_v8", f"bench, G={nh * B}, S={S}",
          sam_flash.sam_global_attention_v8,
          sam_flash.sam_global_attention_v8_plain, (q, k, v, rph, rpw, side),
          flop=4 * nh * B * S * S * hd,
          library_fn=lambda: _sdpa(q, k, v, mask))
    del q, k, v, mask

    # K10: gb's attention half from the bs-8 residual stream
    x = _randn(g, (B, S, C))
    bias = global_block.global_rel_bias_from_x(
        x, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, side, nh, hd)
    check("global_attn_block", f"bench, B={B}, S={S}, C={C}, f32 result",
          global_block.global_attn_block,
          global_block.global_attn_block_plain,
          (x, bias, lw, lb, w_s, b_s, wo, bo, side, nh),
          flop=2 * B * S * C * 3 * C + 4 * B * nh * S * S * hd
          + 2 * B * S * C * C)
    del bias

    # K1: wb, encoder and heads: 8 images of 25 windows
    xw, geom = sam_encoder._windowize(x.reshape(B, side, side, C), ws)
    xw = xw.contiguous()
    valid = sam_encoder._window_valid_tokens(geom, ws, x.device)
    rph, rpw = (_randn(g, (2 * ws - 1, hd), 0.1) for _ in range(2))
    bias = window_block.window_rel_bias_from_x(
        xw, valid, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, ws, nh, hd)
    NW, T = xw.shape[:2]
    check("window_block", f"bench, NW={NW}, T={T}, padded grid",
          window_block.window_block, window_block.window_block_plain,
          (xw, bias, valid, lw, lb, w_s, b_s, wo, bo, l2w, l2b, w1, b1, w2,
           b2, ws, nh),
          flop=NW * T * (2 * C * 3 * C + 2 * C * C + 4 * C * F)
          + 4 * NW * nh * T * T * hd)
    del x, xw, bias

    # K6: the window op's contiguous (G, T, hd) heads, and the (NW, nh, T,
    # hd) views of the windowised qkv that wb and window_path pass
    q, k, v = (_randn(g, (NW * nh, T, hd)) for _ in range(3))
    mask = _attention_mask(q, rph, rpw, ws)  # 246 MB, outside the timing
    check("sam_window_attention_v9", f"bench, G={NW * nh}, T={T}",
          sam_flash.sam_window_attention_v9,
          sam_flash.sam_window_attention_v9_plain, (q, k, v, rph, rpw, ws),
          flop=4 * NW * nh * T * T * hd,
          library_fn=lambda: _sdpa(q, k, v, mask))
    del q, k, v, mask
    qkvw = _randn(g, (NW, T, 3 * C))
    heads = [qkvw[..., i * C:(i + 1) * C].reshape(NW, T, nh, hd).transpose(
        1, 2) for i in range(3)]
    check("sam_window_attention_v9", f"bench, G={NW * nh}, T={T}, (NW, nh, "
          "T, hd) views", sam_flash.sam_window_attention_v9,
          sam_flash.sam_window_attention_v9_plain, (*heads, rph, rpw, ws),
          flop=4 * NW * nh * T * T * hd)
    del qkvw, heads

    # K5: the decoder op's aligned layout: every key valid, every row in the
    # merge (row s belongs to mask s % M), as bench_decoder builds them
    H, hd, S, img_start, n_img = 16, 128, 768, 128, 576
    q, k, v = (_randn(g, (B, S, H, hd)).transpose(1, 2) for _ in range(3))
    valid = torch.ones((B, S), dtype=torch.bool, device="cuda")
    mm = (torch.nn.functional.one_hot(
        torch.arange(S, device="cuda") % MASKS, MASKS).float()
        / (S / MASKS)).expand(B, S, MASKS)
    label = (f"bench decoder: B={B}, H={H}, KV={H}, S={S}, n_img={n_img}, "
             f"M={MASKS}")
    args = (q, k, v, valid, mm, img_start, n_img)
    entry = check("flash_attention_with_merged_capture", label,
                  flash_attention.flash_attention_with_merged_capture,
                  flash_attention.flash_attention_with_merged_capture_plain,
                  args, rel_bounds=(KERNEL_REL_ERR, MERGED_REL_ERR),
                  flop=4 * H * hd * B * S * (S + 1) // 2
                  + 2 * H * MASKS * n_img * B * S)
    capture_passes(entry, "flash_attention_with_merged_capture", label,
                   lambda: flash_attention.flash_attention_with_merged_capture(
                       *args), q, k, v, merged=True)


def global_variant_checks(check, g: torch.Generator) -> None:
    """Phase 3 for the global variants v11, v3, v6, v7, v1, v2 and v4 (K12),
    all on K2's wgmma + TMA core (csrc/relpos_attention_sm90.cu) in their
    softmax modes, at the shapes their paths give them: 4 images x 16 heads
    over the 64 x 64 grid (the bench.py twin and the family matrix at bs 4)
    and 8 images (the kernel bench); then at the grid sides 5 (the tiny
    configs' SAM-80), 28 (SAM-448, 784 keys ending inside a 64-key tile; v11
    there at bs 8) and 80 (SAM-1280, one image), each variant where its JAX
    precondition takes the side.  Each variant's result is also held beside
    K2's (v8) on the same inputs, its wrapper timed beside K2's and beside
    its kernel alone, and the memory its call allocates above its inputs is
    asserted to be its output and the two bf16 tables: no bias rows and no
    scaled copy of q.  v1 and v2 are also held beside v3, whose function
    they are on bf16 inputs at head_dim 64 up to the order of two f32
    additions (v2 = v3 bit for bit: one instantiation)."""
    hd, nh = 64, 16
    sfx = sam_flash_experiments
    variants = {
        name: (getattr(sfx, GLOBAL_WRAPPER[name]),
               getattr(sfx, GLOBAL_WRAPPER[name] + "_plain"))
        for name in ("v11", "v3", "v6", "v7") + NEW_GLOBALS}

    def check_all(label, q, k, v, rph, rpw, side, mask=None):
        ref = sam_flash.sam_global_attention_v8(q, k, v, rph, rpw, side)
        k2_ms = cuda_ms(lambda: sam_flash.sam_global_attention_v8(
            q, k, v, rph, rpw, side))
        G, S, _ = q.shape
        tables = sam_flash.kernel_tables("global", rph, rpw, side,
                                         sam_flash.MAX_TABLE_SIDE)
        out, strides = torch.empty_like(q), (S * hd, 0, hd)
        outs = {}
        for name, (wrapper, plain) in variants.items():
            needs = sfx.GLOBAL_VARIANTS[name][2]
            if needs is not None and needs(S, side) is not None:
                continue  # the JAX function refuses this grid too
            check(GLOBAL_WRAPPER[name], label, wrapper, plain,
                  (q, k, v, rph, rpw, side), flop=4 * G * S * S * hd,
                  library_fn=None if mask is None
                  else lambda: _sdpa(q, k, v, mask))
            # what the call allocates above its inputs, at its peak
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs[name] = wrapper(q, k, v, rph, rpw, side)
            torch.cuda.synchronize()
            added = torch.cuda.max_memory_allocated() - base
            own = _tensor_bytes(outs[name], *tables)
            code = sfx.GLOBAL_VARIANTS[name][0]
            alpha = (1.0 if code == sam_flash.SOFTMAX_NATURAL_BF16
                     else sam_flash.LOG2E) / math.sqrt(hd)
            alone_ms = cuda_ms(lambda: sam_flash.relpos_attention_sm90(
                q, strides, k, v, strides, 1, side, G, S, out, strides,
                tables=tables, softmax=code, alpha=alpha))
            wrapper_ms = cuda_ms(lambda: wrapper(q, k, v, rph, rpw, side))
            diff = (outs[name].float() - ref.float()).abs().max().item()
            log(f"phase 3 {GLOBAL_WRAPPER[name]} [{label}]: max |diff| "
                f"against sam_global_attention_v8 {diff:.3e}; wrapper "
                f"{wrapper_ms:.3f} ms, kernel alone {alone_ms:.3f} ms, "
                f"sam_global_attention_v8 {k2_ms:.3f} ms "
                f"({wrapper_ms / k2_ms:.2f}x); peak memory above its inputs "
                f"{added / 1e6:.1f} MB (its output and tables "
                f"{own / 1e6:.1f} MB)")
            if added > own + (1 << 20):
                raise AssertionError(f"{GLOBAL_WRAPPER[name]} allocates more "
                                     "than its output and tables on the "
                                     "kernel path")
        if "v2" in outs and "v3" in outs:
            log(f"phase 3 global variants [{label}]: v2 equals v3 bit for "
                f"bit: {torch.equal(outs['v2'], outs['v3'])}")
            if not torch.equal(outs["v2"], outs["v3"]):
                raise AssertionError("two names of one kernel instantiation "
                                     "disagree")
        for other in ("v1", "v4"):
            if other in outs and "v3" in outs:
                d = (outs[other].float() - outs["v3"].float()).abs().max()
                log(f"phase 3 global variants [{label}]: {other} against v3 "
                    f"max |diff| {d:.3e}")
        del out, outs, ref

    for B in (BS, BENCH_BS):
        side = 64
        q, k, v = (_randn(g, (nh * B, side * side, hd)) for _ in range(3))
        rph, rpw = (_randn(g, (2 * side - 1, hd), 0.1) for _ in range(2))
        # the library call's mask, 2.1 GB at bs 4 and 4.3 GB at bs 8
        mask = _attention_mask(q, rph, rpw, side)
        check_all(f"G={nh * B}, S={side * side}", q, k, v, rph, rpw, side,
                  mask)
        del mask
    for side, G in ((TRAIN_SAM // 16, nh * TRAIN_BS), (5, nh * BS),
                    (80, nh)):
        q, k, v = (_randn(g, (G, side * side, hd)) for _ in range(3))
        rph, rpw = (_randn(g, (2 * side - 1, hd), 0.1) for _ in range(2))
        check_all(f"side {side}, G={G}, S={side * side}", q, k, v, rph, rpw,
                  side, _attention_mask(q, rph, rpw, side))


def _window_views(g: torch.Generator, NW: int, nh: int = 16, T: int = 196,
                  hd: int = 64) -> list:
    """q, k, v as the encoder's ``_flash_window_core`` passes them: ``(NW,
    nh, T, hd)`` strided views of one windowised ``(NW, T, 3C)`` qkv."""
    C = nh * hd
    qkvw = _randn(g, (NW, T, 3 * C))
    return [qkvw[..., i * C:(i + 1) * C].reshape(NW, T, nh, hd).transpose(
        1, 2) for i in range(3)]


def window_variant_checks(check, g: torch.Generator) -> None:
    """Phase 3 for the window variants v1, v6, v7, v8, v2, v3, v4 and v5
    (K12) at the shapes their paths give them: the kernel bench's 3200
    contiguous window-heads (8 images x 25 windows x 16 heads), the same as
    views of a windowised qkv, and the views of the SAM-768 bs-4 encoder (64
    windows).  Each variant's result is also held beside K6's (v9) on the
    same inputs, and its wrapper is timed beside its kernel alone (the
    wrappers run no plain preparation).  The bytes counted are q, k, v, the
    output and the two tables, as for K6.  The memory the v2 wrapper
    allocates above its inputs is its output and the two bf16 tables: the
    dense bias of the plain version is not made."""
    ws, hd, nh = 14, 64, 16
    T = ws * ws
    sfx = sam_flash_experiments
    variants = {"v1": (sfx.sam_window_attention,
                       sfx.sam_window_attention_plain)}
    variants.update({
        name: (getattr(sfx, f"sam_window_attention_{name}"),
               getattr(sfx, f"sam_window_attention_{name}_plain"))
        for name in ("v6", "v7", "v8", "v2") + NEW_WINDOWS})
    rph, rpw = (_randn(g, (2 * ws - 1, hd), 0.1) for _ in range(2))
    inputs = (
        (f"bench, G={200 * nh}, T={T}",
         [_randn(g, (200 * nh, T, hd)) for _ in range(3)]),
        (f"bench, G={200 * nh}, T={T}, (NW, nh, T, hd) views",
         _window_views(g, 200)),
        (f"SAM-768 bs 4, G={64 * nh}, T={T}, (NW, nh, T, hd) views",
         _window_views(g, 64)))
    for label, (q, k, v) in inputs:
        G = q.numel() // (T * hd)
        mask = _attention_mask(q.reshape(G, T, hd), rph, rpw, ws)
        if q.dim() == 4:
            mask = mask.reshape(-1, nh, T, T)
        ref = sam_flash.sam_window_attention_v9(q, k, v, rph, rpw, ws)
        outs = {}
        nh_l = 1 if q.dim() == 3 else nh
        tables = sam_flash.kernel_tables("window", rph, rpw, ws,
                                         sfx.MAX_WINDOW_SIDE)
        if q.dim() == 3:
            out, o_str = torch.empty_like(q), (T * hd, 0, hd)
        else:
            out = torch.empty((q.shape[0], T, nh, hd), dtype=q.dtype,
                              device="cuda")
            o_str = (T * nh * hd, hd, nh * hd)
        q_str, kv_str = (sam_flash._head_strides("window", t) for t in (q, k))
        for name, (wrapper, plain) in variants.items():
            check(WINDOW_WRAPPER[name], label, wrapper, plain,
                  (q, k, v, rph, rpw, ws), flop=4 * G * T * T * hd,
                  library_fn=lambda: _sdpa(q, k, v, mask))
            outs[name] = wrapper(q, k, v, rph, rpw, ws)
            diff = (outs[name].float() - ref.float()).abs().max().item()
            wrapper_ms = cuda_ms(lambda: wrapper(q, k, v, rph, rpw, ws))
            alone_ms = cuda_ms(lambda: sfx.window_attention_sm90(
                q, q_str, k, v, kv_str, nh_l, tables, ws, G, T,
                sfx.WINDOW_MODES[name], out, o_str))
            log(f"phase 3 {WINDOW_WRAPPER[name]} [{label}]: max |diff| "
                f"against sam_window_attention_v9 {diff:.3e}; wrapper "
                f"{wrapper_ms:.3f} ms, kernel alone {alone_ms:.3f} ms, plain "
                "preparation on the kernel path: none")
        # scale = 2**-3 at head_dim 64, so scaling q commutes with rounding
        # it: the two kernel instantiations are one function of bf16 inputs
        log(f"phase 3 window variants [{label}]: v1 equals v6 bit for bit: "
            f"{torch.equal(outs['v1'], outs['v6'])}, v7 equals v8: "
            f"{torch.equal(outs['v7'], outs['v8'])}, v1 equals v7: "
            f"{torch.equal(outs['v1'], outs['v7'])}; v2 against v7 max |diff| "
            f"{(outs['v2'].float() - outs['v7'].float()).abs().max():.3e}")
        if not (torch.equal(outs["v1"], outs["v6"])
                and torch.equal(outs["v7"], outs["v8"])):
            raise AssertionError("two names of one kernel instantiation "
                                 "disagree")
        # v3 runs v7's instantiation behind its own wrapper: logged, not
        # asserted; v4 and v5 round the softmax at other places
        log(f"phase 3 window variants [{label}]: v3 equals v7 bit for bit: "
            f"{torch.equal(outs['v3'], outs['v7'])}; v4 against v7 max |diff| "
            f"{(outs['v4'].float() - outs['v7'].float()).abs().max():.3e}, "
            f"v5 against v7 "
            f"{(outs['v5'].float() - outs['v7'].float()).abs().max():.3e}")
        del mask, ref, outs
        # v2's kernel path: what its call adds to the allocated memory at
        # its peak, against its output and tables (the plain version's
        # dense bias would be G * 208 * 208 * 2 bytes)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        v2_out = sfx.sam_window_attention_v2(q, k, v, rph, rpw, ws)
        torch.cuda.synchronize()
        added = torch.cuda.max_memory_allocated() - base
        own = _tensor_bytes(v2_out, *tables)
        dense = G * 208 * 208 * 2
        log(f"phase 3 sam_window_attention_v2 [{label}]: peak memory above "
            f"its inputs {added / 1e6:.1f} MB (its output and tables "
            f"{own / 1e6:.1f} MB; the plain dense bias {dense / 1e6:.1f} MB "
            "is not made)")
        if added > own + (1 << 20):
            raise AssertionError("sam_window_attention_v2 allocates more "
                                 "than its output on the kernel path")
        del v2_out, out


def sweep_shape_checks(check, g: torch.Generator) -> None:
    """Phase 3 at the shapes the size sweep's SAM-768 and SAM-640 points
    (phase 17, bs 4) give the kernels of the earlier paths: K6 over 64 and
    36 padded windows, K3 and K4 over 9216 and 6400 token rows, K2 over
    sides 48 and 40 (1600 keys end inside a 64-key tile and are no multiple
    of 128)."""
    C, F, hd, nh, ws = 1024, 4096, 64, 16, 14
    T = ws * ws
    lw, lb = _randn(g, (C,), 0.1, 1.0), _randn(g, (C,), 0.1)
    wqkv, bqkv = _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), 0.1)
    wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
    w1, b1 = _randn(g, (C, F), C ** -0.5), _randn(g, (F,), 0.1)
    w2, b2 = _randn(g, (F, C), F ** -0.5), _randn(g, (C,), 0.1)
    for size in SWEEP_SIZES:
        side = size // 16
        NW, N = BS * (-(-side // ws)) ** 2, BS * side * side
        x, a = _randn(g, (N, C)), _randn(g, (N, C))
        label = f"SAM-{size} bs {BS}, N={N}"
        check("fused_ln_qkv", label, fused_block.fused_ln_qkv,
              fused_block.fused_ln_qkv_plain, (x, lw, lb, wqkv, bqkv, 1e-6),
              flop=2 * N * C * 3 * C)
        check("fused_proj_ln_mlp", label, fused_block.fused_proj_ln_mlp,
              fused_block.fused_proj_ln_mlp_plain,
              (x, a, wo, bo, lw, lb, w1, b1, w2, b2, 1e-6, "gelu"),
              flop=2 * N * C * C + 4 * N * C * F)
        del x, a

        heads = _window_views(g, NW)
        rph, rpw = (_randn(g, (2 * ws - 1, hd), 0.1) for _ in range(2))
        mask = _attention_mask(heads[0].reshape(NW * nh, T, hd), rph, rpw,
                               ws).reshape(NW, nh, T, T)
        check("sam_window_attention_v9", f"SAM-{size} bs {BS}, G={NW * nh}, "
              f"T={T}, (NW, nh, T, hd) views",
              sam_flash.sam_window_attention_v9,
              sam_flash.sam_window_attention_v9_plain, (*heads, rph, rpw, ws),
              flop=4 * NW * nh * T * T * hd,
              library_fn=lambda: _sdpa(*heads, mask))

        q, k, v = (_randn(g, (nh * BS, side * side, hd)) for _ in range(3))
        rph, rpw = (_randn(g, (2 * side - 1, hd), 0.1) for _ in range(2))
        mask = _attention_mask(q, rph, rpw, side)  # outside the timing
        check("sam_global_attention_v8", f"SAM-{size} bs {BS}, G={nh * BS}, "
              f"S={side * side}", sam_flash.sam_global_attention_v8,
              sam_flash.sam_global_attention_v8_plain,
              (q, k, v, rph, rpw, side), flop=4 * nh * BS * side ** 4 * hd,
              library_fn=lambda: _sdpa(q, k, v, mask))
        del heads, q, k, v, mask


def family_shape_checks(check, g: torch.Generator) -> None:
    """Phase 3 at the shapes the family matrix (phase 20, bs 4) gives K3 and
    K4 in the CLIP-L towers of LLaVA-1.5 (577 tokens an image) and HPT-Air
    (785 at 392 px): quick_gelu, LayerNorm eps 1e-5.  Their SAM-1024 shapes
    (K1 at NW=100, K3 / K4 at N=16384, the global variants at G=64) are held
    above."""
    C, F = 1024, 4096
    lw, lb = _randn(g, (C,), 0.1, 1.0), _randn(g, (C,), 0.1)
    wqkv, bqkv = _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), 0.1)
    wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
    w1, b1 = _randn(g, (C, F), C ** -0.5), _randn(g, (F,), 0.1)
    w2, b2 = _randn(g, (F, C), F ** -0.5), _randn(g, (C,), 0.1)
    for family, _, preset, tokens in FAMILY_POINTS:
        N = BS * tokens
        x, a = _randn(g, (N, C)), _randn(g, (N, C))
        label = f"{family} {preset} CLIP-L, N={N}, quick_gelu"
        check("fused_ln_qkv", label, fused_block.fused_ln_qkv,
              fused_block.fused_ln_qkv_plain, (x, lw, lb, wqkv, bqkv, 1e-5),
              flop=2 * N * C * 3 * C)
        check("fused_proj_ln_mlp", label, fused_block.fused_proj_ln_mlp,
              fused_block.fused_proj_ln_mlp_plain,
              (x, a, wo, bo, lw, lb, w1, b1, w2, b2, 1e-5, "quick_gelu"),
              flop=2 * N * C * C + 4 * N * C * F)


def generation_shape_checks(check, g: torch.Generator) -> None:
    """Phase 3 at the shapes the generation path (phase 24) gives the
    kernels: K3 and K4 over the SAM global rows of one image (N = 4096) and
    the SigLIP rows of one and two images (N = 576, 1152), K2 over one
    image's 16 heads (G = 16, S = 4096), K1 over one image's 25 windows."""
    C, F, hd, nh, ws, side = 1024, 4096, 64, 16, 14, 64
    S = side * side
    lw, lb = _randn(g, (C,), 0.1, 1.0), _randn(g, (C,), 0.1)
    l2w, l2b = _randn(g, (C,), 0.1, 1.0), _randn(g, (C,), 0.1)
    wqkv, bqkv = _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), 0.1)
    wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
    w1, b1 = _randn(g, (C, F), C ** -0.5), _randn(g, (F,), 0.1)
    w2, b2 = _randn(g, (F, C), F ** -0.5), _randn(g, (C,), 0.1)
    for label, N in (("generation SAM global bs 1, N=4096", S),
                     ("generation SigLIP bs 1, N=576", 576),
                     ("generation SigLIP bs 2, N=1152", 1152)):
        x, a = _randn(g, (N, C)), _randn(g, (N, C))
        check("fused_ln_qkv", label, fused_block.fused_ln_qkv,
              fused_block.fused_ln_qkv_plain, (x, lw, lb, wqkv, bqkv, 1e-6),
              flop=2 * N * C * 3 * C)
        check("fused_proj_ln_mlp", label, fused_block.fused_proj_ln_mlp,
              fused_block.fused_proj_ln_mlp_plain,
              (x, a, wo, bo, lw, lb, w1, b1, w2, b2, 1e-6, "gelu"),
              flop=2 * N * C * C + 4 * N * C * F)
    del x, a

    q, k, v = (_randn(g, (nh, S, hd)) for _ in range(3))
    rph, rpw = (_randn(g, (2 * side - 1, hd), 0.1) for _ in range(2))
    mask = _attention_mask(q, rph, rpw, side)  # outside the timing
    check("sam_global_attention_v8", f"generation bs 1, G={nh}, S={S}",
          sam_flash.sam_global_attention_v8,
          sam_flash.sam_global_attention_v8_plain, (q, k, v, rph, rpw, side),
          flop=4 * nh * S * S * hd, library_fn=lambda: _sdpa(q, k, v, mask))
    del q, k, v, mask

    w_s, b_s = window_block.scaled_qkv_weights(wqkv, bqkv, nh, hd)
    x = _randn(g, (1, side, side, C))
    xw, geom = sam_encoder._windowize(x, ws)
    xw = xw.contiguous()
    valid = sam_encoder._window_valid_tokens(geom, ws, x.device)
    rph, rpw = (_randn(g, (2 * ws - 1, hd), 0.1) for _ in range(2))
    bias = window_block.window_rel_bias_from_x(
        xw, valid, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, ws, nh, hd)
    NW, T = xw.shape[:2]
    check("window_block", f"generation bs 1, NW={NW}, T={T}, padded grid",
          window_block.window_block, window_block.window_block_plain,
          (xw, bias, valid, lw, lb, w_s, b_s, wo, bo, l2w, l2b, w1, b1, w2,
           b2, ws, nh),
          flop=NW * T * (2 * C * 3 * C + 2 * C * C + 4 * C * F)
          + 4 * NW * nh * T * T * hd)


def sm90_checks(check, results: dict, g: torch.Generator) -> None:
    """Phase 3 for what came with the wgmma + TMA cores: K3, K4 and K8 at the
    widths of SAM ViT-B (C = 768, F = 3072) and ViT-H (C = 1280, F = 5120)
    over a few hundred rows; K2's kernel alone beside its wrapper and K1's
    three launches one by one beside the whole, at the bs-4 SAM-1024 shapes
    (recorded as ``split_ms`` on their entries), with the plain rel-pos bias
    rows computed in front of every K1 call."""
    hd, nh = 64, 16
    for C, N, act in ((768, 400, "gelu"), (1280, 520, "quick_gelu")):
        F = 4 * C
        x, a = _randn(g, (N, C)), _randn(g, (N, C))
        lw, lb = _randn(g, (C,), 0.1, 1.0), _randn(g, (C,), 0.1)
        wqkv, bqkv = _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), .1)
        wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
        w1, b1 = _randn(g, (C, F), C ** -0.5), _randn(g, (F,), 0.1)
        w2, b2 = _randn(g, (F, C), F ** -0.5), _randn(g, (C,), 0.1)
        label = f"C={C}, F={F}, N={N}, {act}"
        check("fused_ln_qkv", label, fused_block.fused_ln_qkv,
              fused_block.fused_ln_qkv_plain, (x, lw, lb, wqkv, bqkv, 1e-6),
              flop=2 * N * C * 3 * C)
        check("fused_proj_ln_mlp", label, fused_block.fused_proj_ln_mlp,
              fused_block.fused_proj_ln_mlp_plain,
              (x, a, wo, bo, lw, lb, w1, b1, w2, b2, 1e-6, act),
              flop=2 * N * C * C + 4 * N * C * F)
        check("fused_ln_mlp", label, fused_block.fused_ln_mlp,
              fused_block.fused_ln_mlp_plain,
              (x, lw, lb, w1, b1, w2, b2, 1e-6, act), flop=4 * N * C * F)

    # K2: the wrapper (two table casts and the output) and the kernel alone
    side = 64
    S = side * side
    q, k, v = (_randn(g, (nh * BS, S, hd)) for _ in range(3))
    rph, rpw = (_randn(g, (2 * side - 1, hd), 0.1) for _ in range(2))
    out = torch.empty_like(q)
    tables = [t.contiguous() for t in (rph, rpw)]
    strides = (S * hd, 0, hd)
    split = {
        "wrapper": cuda_ms(lambda: sam_flash.sam_global_attention_v8(
            q, k, v, rph, rpw, side)),
        "kernel alone": cuda_ms(lambda: sam_flash.relpos_attention_sm90(
            q, strides, k, v, strides, 1, side, nh * BS, S, out, strides,
            tables=tables, alpha=sam_flash.LOG2E / math.sqrt(hd)))}
    results["sam_global_attention_v8"]["split_ms"] = split
    log(f"phase 3 sam_global_attention_v8 [G={nh * BS}, S={S}]: wrapper "
        f"{split['wrapper']:.3f} ms, kernel alone {split['kernel alone']:.3f}"
        " ms")
    del q, k, v, out

    # K1 at NW=100: its three launches, the whole wrapper, and the plain bias
    # rows the encoder computes in front of it
    C, F, ws = 1024, 4096, 14
    xw, geom = sam_encoder._windowize(_randn(g, (BS, side, side, C)), ws)
    xw = xw.contiguous()
    NW, T = xw.shape[:2]
    valid = sam_encoder._window_valid_tokens(geom, ws, xw.device)
    lw, lb = _randn(g, (C,), 0.1, 1.0), _randn(g, (C,), 0.1)
    w_s, b_s = window_block.scaled_qkv_weights(
        _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), 0.1), nh, hd)
    wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
    w1, b1 = _randn(g, (C, F), C ** -0.5), _randn(g, (F,), 0.1)
    w2, b2 = _randn(g, (F, C), F ** -0.5), _randn(g, (C,), 0.1)
    rph, rpw = (_randn(g, (2 * ws - 1, hd), 0.1) for _ in range(2))
    bias = window_block.window_rel_bias_from_x(
        xw, valid, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, ws, nh, hd)
    xf, rows_valid = xw.reshape(NW * T, C), valid.reshape(-1)
    qkv = torch.empty((NW * T, 3 * C), dtype=xw.dtype, device="cuda")
    attn, out = torch.empty_like(xf), torch.empty_like(xf)
    strides = (T * 3 * C, hd, 3 * C)
    split = {
        "ln_gemm": cuda_ms(lambda: fused_block.ln_gemm(
            xf, lw, lb, 1e-6, rows_valid, w_s, b_s, qkv)),
        "attention": cuda_ms(lambda: sam_flash.relpos_attention_sm90(
            qkv, strides, qkv[:, C:], qkv[:, 2 * C:], strides, nh, ws,
            NW * nh, T, attn, (T * C, hd, C), bias=bias)),
        "block_tail": cuda_ms(lambda: fused_block.block_tail(
            xf, attn, wo, bo, lw, lb, 1e-6, w1, b1, w2, b2, "gelu", out)),
        "whole": cuda_ms(lambda: window_block.window_block(
            xw, bias, valid, lw, lb, w_s, b_s, wo, bo, lw, lb, w1, b1, w2, b2,
            ws, nh)),
        "bias rows (plain, outside K1)": cuda_ms(
            lambda: window_block.window_rel_bias_from_x(
                xw, valid, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, ws, nh,
                hd))}
    results["window_block"]["split_ms"] = split
    log(f"phase 3 window_block [NW={NW}]: " + ", ".join(
        f"{part} {ms:.3f} ms" for part, ms in split.items()))


def side_checks(check, g: torch.Generator) -> None:
    """Phase 3 at the grid sides the rel-pos core takes beyond those of the
    paths above: K2 at sides 5 (the tiny configs' SAM-80 grid), 7, 80
    (SAM-1280) and 128 (SAM-2048, one image: the f32 bias rows leave room
    for one consumer warpgroup a block); K6 at window side 7; K10 at side 5,
    where its wrapper runs the same kernel from bias rows.  The SDPA mask of
    side 128 would take 8.6 GB: no library call there."""
    hd, nh, C = 64, 16, 1024
    for side, imgs in ((5, BS), (7, BS), (80, 1), (128, 1)):
        S, G = side * side, nh * imgs
        q, k, v = (_randn(g, (G, S, hd)) for _ in range(3))
        rph, rpw = (_randn(g, (2 * side - 1, hd), 0.1) for _ in range(2))
        mask = _attention_mask(q, rph, rpw, side) if side < 128 else None
        check("sam_global_attention_v8", f"side {side}, G={G}, S={S}",
              sam_flash.sam_global_attention_v8,
              sam_flash.sam_global_attention_v8_plain,
              (q, k, v, rph, rpw, side), flop=4 * G * S * S * hd,
              library_fn=(None if mask is None
                          else lambda: _sdpa(q, k, v, mask)))
        del q, k, v, mask

    ws, NW = 7, 4 * BS
    T = ws * ws
    heads = _window_views(g, NW, nh, T)
    rph, rpw = (_randn(g, (2 * ws - 1, hd), 0.1) for _ in range(2))
    mask = _attention_mask(heads[0].reshape(NW * nh, T, hd), rph, rpw,
                           ws).reshape(NW, nh, T, T)
    check("sam_window_attention_v9", f"window side {ws}, G={NW * nh}, "
          f"T={T}, (NW, nh, T, hd) views", sam_flash.sam_window_attention_v9,
          sam_flash.sam_window_attention_v9_plain, (*heads, rph, rpw, ws),
          flop=4 * NW * nh * T * T * hd,
          library_fn=lambda: _sdpa(*heads, mask))
    del heads, mask

    side = 5
    S = side * side
    x = _randn(g, (BS, S, C))
    lw, lb = _randn(g, (C,), 0.1, 1.0), _randn(g, (C,), 0.1)
    w_s, b_s = window_block.scaled_qkv_weights(
        _randn(g, (C, 3 * C), C ** -0.5), _randn(g, (3 * C,), 0.1), nh, hd)
    wo, bo = _randn(g, (C, C), C ** -0.5), _randn(g, (C,), 0.1)
    rph, rpw = (_randn(g, (2 * side - 1, hd), 0.1) for _ in range(2))
    bias = global_block.global_rel_bias_from_x(
        x, lw, lb, w_s[:, :C], b_s[:C], rph, rpw, side, nh, hd)
    check("global_attn_block", f"side {side}, B={BS}, S={S}, C={C}, f32 "
          "result", global_block.global_attn_block,
          global_block.global_attn_block_plain,
          (x, bias, lw, lb, w_s, b_s, wo, bo, side, nh),
          flop=2 * BS * S * C * 3 * C + 4 * BS * nh * S * S * hd
          + 2 * BS * S * C * C)


def run_requests(forward, params, cfg, batches) -> tuple[list, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [forward(params, cfg, b) for b in batches]
    torch.cuda.synchronize()
    return outs, (time.perf_counter() - t0) * 1e3 / len(batches)


def randomize_rel_pos(params, g) -> None:
    """Non-zero SAM rel-pos tables, so the bias terms of K1 and K2 work."""
    for bp in params["frozen"]["sam_encoder"]["blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            bp[key] = _randn(g, bp[key].shape, 0.05)


def phase_serve(phase, path, forward, params, cfg, batches, shapes) -> dict:
    """Warm up, then serve the requests with every launch count at 0 just
    before and read just after; check shapes, finite values and counts."""
    warm, requests = batches[0], batches[1:]
    with torch.no_grad():
        forward(params, cfg, warm)  # warm-up
        for fn in WRAPPERS.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        outs, ms = run_requests(forward, params, cfg, requests)
        launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in outs:
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape:
                raise AssertionError(f"{key} shape {tuple(out[key].shape)}"
                                     f" != {shape}")
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"{key} has non-finite values")
    want = {k: n * len(requests) for k, n in EXPECTED_LAUNCHES[path].items()}
    bs = shapes["iou_pred"][0]
    log(f"phase {phase} serve {path}: {len(requests)} requests at bs {bs}, "
        f"outputs finite with the expected shapes; launches {launches} "
        f"(expected {want}); peak memory {peak_gb:.2f} GB")
    if launches != want:
        raise AssertionError("kernel launch counts differ from the main path")
    return {"requests": requests, "outs": outs, "ms": ms,
            "launches": launches, "peak_gb": peak_gb, "bs": bs}


def phase_compare(phase, path, forward, params, cfg, served,
                  pairs_fn) -> None:
    """The kernel forward against the all-plain forward on one batch, then
    the plain path's time and peak memory over the same requests."""
    plain = registry.plain_config(cfg)
    batch = served["requests"][0]
    with torch.no_grad():
        pairs = pairs_fn(cfg, plain, batch)
        ref = forward(params, plain, batch)
        pairs.update({k: (served["outs"][0][k], ref[k]) for k in
                      ("hidden", "coarse_logits", "sam_logits")})
        for key, (got, want) in pairs.items():
            rel, corr = agreement(got, want)
            log(f"phase {phase} {path} {key}: kernel vs plain forward "
                f"max_rel_err {rel:.3e} corr {corr:.6f} (bound "
                f"{FORWARD_CORR[key]})")
            if corr < FORWARD_CORR[key]:
                raise AssertionError(f"{path} {key}: kernel forward "
                                     "disagrees with the plain forward")
        del pairs, ref
        torch.cuda.reset_peak_memory_stats()
        _, served["plain_ms"] = run_requests(forward, params, plain,
                                             served["requests"])
        served["plain_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9


def run_deepseek(g: torch.Generator) -> dict:
    cfg = deepseek_vl.deepseek_vl_1_3b()
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")  # the forward never uses it
    randomize_rel_pos(params, g)
    batches = [from_jax(synthetic_batch(
        cfg, batch_size=BS, seq_len=SEQ, max_masks=MASKS,
        text_tokens_per_mask=TEXT, seed=seed), "cuda") for seed in range(4)]
    Hc, Wc = unet.output_hw(cfg.unet, (cfg.clip_shape, cfg.clip_shape))
    shapes = {"sam_logits": (BS, MASKS, 256, 256),
              "coarse_logits": (BS, MASKS, Hc, Wc),
              "iou_pred": (BS, MASKS), "boxes": (BS, MASKS, 4),
              "hidden": (BS, SEQ, cfg.llm.hidden_size)}
    served = phase_serve(4, "deepseek_vl_1_3b", grounding.forward, params,
                         cfg, batches, shapes)

    def sam_embedding(cfg, plain, batch):
        emb = [sam_encoder.forward(params["frozen"]["sam_encoder"],
                                   c.sam.encoder, batch["sam_pixel_values"])
               for c in (cfg, plain)]
        return {"sam_embedding": tuple(emb)}

    phase_compare(5, "deepseek_vl_1_3b", grounding.forward, params, cfg,
                  served, sam_embedding)
    return served


def run_llava_next(g: torch.Generator) -> dict:
    cfg = llava_next.llava_next_vicuna_7b(img_start=ANYRES_IMG_START)
    params = llava_next_model.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    randomize_rel_pos(params, g)
    batches = anyres_batches(cfg, "cuda")
    S = batches[0]["input_ids"].shape[1]
    Hc, Wc = cfg.coarse_frame
    shapes = {"sam_logits": (ANYRES_BS, MASKS, 256, 256),
              "coarse_logits": (ANYRES_BS, MASKS, Hc, Wc),
              "iou_pred": (ANYRES_BS, MASKS), "boxes": (ANYRES_BS, MASKS, 4),
              "hidden": (ANYRES_BS, S, cfg.base.llm.hidden_size)}
    served = phase_serve(6, "llava_next_vicuna_7b", llava_next_model.forward,
                         params, cfg, batches, shapes)

    def merged_maps(cfg, plain, batch):
        return {"attn": tuple(
            llava_next_model.capture(params, c, batch)["attn"]
            for c in (cfg, plain))}

    phase_compare(7, "llava_next_vicuna_7b", llava_next_model.forward,
                  params, cfg, served, merged_maps)
    served["seq_len"] = S
    return served


def run_hpt(g: torch.Generator) -> dict:
    """Phases 11-12: the HPT-Air-1.5 serving forward."""
    cfg = hpt_config()
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    randomize_rel_pos(params, g)
    batches = hpt_batches(cfg, 4, "cuda")
    Hc, Wc = unet.output_hw(cfg.unet, (cfg.clip_shape, cfg.clip_shape))
    shapes = {"sam_logits": (BS, MASKS, 256, 256),
              "coarse_logits": (BS, MASKS, Hc, Wc),
              "iou_pred": (BS, MASKS), "boxes": (BS, MASKS, 4),
              "hidden": (BS, HPT_SEQ, cfg.llm.hidden_size)}
    served = phase_serve(11, "hpt_air_1_5", grounding.forward, params, cfg,
                         batches, shapes)

    def tower_and_sam(cfg, plain, batch):
        fro = params["frozen"]
        return {
            "vision_features": tuple(vit.forward(
                fro["vision"], c.vision, batch["pixel_values"],
                select_layer=c.vision_select_layer) for c in (cfg, plain)),
            "sam_embedding": tuple(sam_encoder.forward(
                fro["sam_encoder"], c.sam.encoder, batch["sam_pixel_values"])
                for c in (cfg, plain))}

    phase_compare(12, "hpt_air_1_5", grounding.forward, params, cfg, served,
                  tower_and_sam)
    served["seq_len"] = HPT_SEQ
    return served


def _flat_grads(grads: dict, path: str) -> torch.Tensor:
    """One subtree's gradients as one f32 vector; leaves without one (the
    frozen pe_gaussian, heads the loss never reads) are left out."""
    return torch.cat([g.float().flatten() for p, g in grads.items()
                      if (p == path or p.startswith(path + "/"))
                      and g is not None])


def _zeros_like(tree):
    """A tree of zeros shaped like ``tree`` (a restore template)."""
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _clone_tree(tree: dict, device=None) -> dict:
    return {p: t.detach().to(device or t.device, copy=True)
            for p, t in train_loop.tree_leaves(tree)}


def _run_steps(step, state, frozen, batches) -> tuple[list, float]:
    """Steps over ``batches``; (per-step metrics as floats, ms per step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [step(state, frozen, b)[1] for b in batches]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, m in enumerate(metrics):
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"step {i}: non-finite loss or grad_norm "
                                 f"{m['loss']} {m['grad_norm']}")
    return metrics, ms


def run_train(g: torch.Generator) -> dict:
    """Phases 8-10: the DeepSeek-VL-1.3B heads trained at the SAM-448
    schedule through the port's train step, under PyTorch's deterministic
    algorithms.  The heads' gradient is ill-conditioned (phase 9), and the
    atomic sums of the default backward kernels moved the state the steps
    reach, and with it phase 9's correlations, from one run of the same
    code to the next; with the switch on, two runs give the same bits."""
    path = "deepseek_vl_1_3b_train_sam448"
    cfg = registry.with_sam_size(deepseek_vl.deepseek_vl_1_3b(), TRAIN_SAM)
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")  # the loss never reads it
    randomize_rel_pos(params, g)
    frozen = params["frozen"]
    batches = [from_jax(synthetic_batch(cfg, batch_size=TRAIN_BS, seed=i),
                        "cuda") for i in range(1 + TRAIN_STEPS)]
    opt = train_loop.make_optimizer(train_loop.OptimConfig(
        lr=TRAIN_LR, total_steps=2 * (1 + TRAIN_STEPS)))
    state = train_loop.init_state(params["trainable"], opt)
    torch.use_deterministic_algorithms(True)
    try:
        result = train_phase(path, cfg, opt, state, frozen, batches)
        result.update(compare_train_phase(path, cfg, opt, state, frozen,
                                          batches))
        repeated_batch_phase(path, cfg, state, frozen, batches[1])
    finally:
        torch.use_deterministic_algorithms(False)
    return result


def restored_equal(state: dict, opt, work) -> None:
    """The newest checkpoint under ``work``, restored into a zero state,
    equals ``state`` leaf for leaf, bit for bit."""
    template = train_loop.init_state(_zeros_like(state["params"]), opt)
    restored = ckpt.restore(ckpt.latest(work), template)
    for (p, a), (_, b) in zip(train_loop.tree_leaves(state),
                              train_loop.tree_leaves(restored)):
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        if not same:
            raise AssertionError(f"checkpoint round trip changed {p}")


def train_phase(path, cfg, opt, state, frozen, batches) -> dict:
    """Phase 8: a warm-up and the timed steps with their launch counts,
    every trainable subtree changed, the frozen tree untouched, and a
    checkpoint round trip."""
    step = train_loop.make_train_step(
        lambda p, b: grounding.loss_fn(p, cfg, b), opt)
    # on the host, so the copy does not count in the steps' peak memory
    frozen_before = _clone_tree(frozen, "cpu")
    trainable_before = _clone_tree(state["params"])
    warm, _ = _run_steps(step, state, frozen, batches[:1])
    for fn in WRAPPERS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    metrics, ms = _run_steps(step, state, frozen, batches[1:])
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: n * TRAIN_STEPS for k, n in EXPECTED_LAUNCHES[path].items()}
    log(f"phase 8 train {path}: {TRAIN_STEPS} steps at bs {TRAIN_BS} after "
        f"one warm-up, loss {[round(m['loss'], 4) for m in warm + metrics]} "
        f"grad_norm {[round(m['grad_norm'], 4) for m in warm + metrics]}; "
        f"launches {launches} (expected {want}); peak memory "
        f"{peak_gb:.2f} GB")
    if launches != want:
        raise AssertionError("kernel launch counts differ from the main path")
    after = _clone_tree(state["params"])
    for sub in SUBTREES:
        if all(torch.equal(t, trainable_before[p]) for p, t in after.items()
               if p == sub or p.startswith(sub + "/")):
            raise AssertionError(f"trainable subtree {sub} did not change")
    for p, t in train_loop.tree_leaves(frozen):
        if t.requires_grad or not torch.equal(t.cpu(), frozen_before[p]):
            raise AssertionError(f"frozen leaf {p} changed or needs grad")
    log(f"phase 8 train {path}: every trainable subtree {SUBTREES} changed, "
        "the frozen tree is bit for bit unchanged")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(pathlib.Path(tmp) / f"step_{state['step']}", state)
        restored_equal(state, opt, tmp)
    log(f"phase 8 train {path}: checkpoint save / restore round trip of "
        f"step {state['step']} holds")
    return {"ms": ms, "launches": launches, "peak_gb": peak_gb,
            "bs": TRAIN_BS, "n": TRAIN_STEPS, "unit": "step"}


def step_against_plain(phase: int, path: str, loss_fn, cfg, trainable,
                       frozen, batch) -> None:
    """One step's loss (within ``STEP_LOSS_REL``) and the gradient of each
    trainable subtree (corr >= ``STEP_GRAD_CORR``) on the kernel path
    against the all-plain path, from the same state and batch."""
    plain = registry.plain_config(cfg)
    (loss_k, _), grads_k = train_loop.value_and_grad(
        lambda p, b: loss_fn(p, cfg, b), frozen, trainable, batch)
    (loss_p, _), grads_p = train_loop.value_and_grad(
        lambda p, b: loss_fn(p, plain, b), frozen, trainable, batch)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    log(f"phase {phase} {path}: kernel vs plain step loss {float(loss_k):.6f}"
        f" vs {float(loss_p):.6f}, rel diff {rel:.3e} (bound "
        f"{STEP_LOSS_REL})")
    if rel > STEP_LOSS_REL:
        raise AssertionError("the kernel step's loss disagrees with the "
                             "plain step's")
    for sub in SUBTREES:
        _, corr = agreement(_flat_grads(grads_k, sub),
                            _flat_grads(grads_p, sub))
        log(f"phase {phase} {path}: gradient of {sub}: corr {corr:.6f} "
            f"(bound {STEP_GRAD_CORR})")
        if corr < STEP_GRAD_CORR:
            raise AssertionError(f"the kernel step's gradient of {sub} "
                                 "disagrees with the plain step's")


def compare_train_phase(path, cfg, opt, state, frozen, batches) -> dict:
    """Phase 9: the loss and gradients of one step from the trained state
    on the kernel path and the all-plain path, then the plain path's step
    time.  The U-Net's gradient through the SAM loss is ill-conditioned
    where coarse logits sit near 0 (the mask downscaler's LayerNorm over 4
    channels of a locally flat dense prompt), so it is compared at the
    state the timed steps leave, not after the repeated-batch phase."""
    step_against_plain(9, path, grounding.loss_fn, cfg, state["params"],
                       frozen, batches[1])
    plain = registry.plain_config(cfg)
    plain_step = train_loop.make_train_step(
        lambda p, b: grounding.loss_fn(p, plain, b), opt)
    _run_steps(plain_step, state, frozen, batches[:1])
    torch.cuda.reset_peak_memory_stats()
    _, plain_ms = _run_steps(plain_step, state, frozen, batches[1:])
    return {"plain_ms": plain_ms,
            "plain_peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def repeated_batch_phase(path, cfg, state, frozen, batch) -> None:
    """Phase 10: steps on one repeated batch (the recipe's lr, no warmup)
    lower its loss."""
    opt = train_loop.make_optimizer(train_loop.OptimConfig(
        lr=TRAIN_LR, total_steps=REPEATED_STEPS, warmup_ratio=0.0))
    step = train_loop.make_train_step(
        lambda p, b: grounding.loss_fn(p, cfg, b), opt)
    metrics, _ = _run_steps(step, train_loop.init_state(state["params"], opt),
                            frozen, [batch] * REPEATED_STEPS)
    losses = [m["loss"] for m in metrics]
    log(f"phase 10 train {path}: {REPEATED_STEPS} steps on one batch (lr "
        f"{TRAIN_LR}, no warmup): loss {[round(x, 4) for x in losses]}")
    if not losses[-1] < losses[0]:
        raise AssertionError("the repeated batch's loss did not fall")


def run_kernel_bench(g: torch.Generator) -> dict:
    """Phase 13: every op of the kernel bench at bs 8 and full width, with
    every launch count at 0 just before and read just after."""
    n = kernel_bench.WARMUP + BENCH_ITERS  # calls per measurement
    counts = {}

    def emit(op, rows):
        for row in rows:
            log(f"phase 13 kernel_bench {json.dumps(row)}")
        counts[op] = {name: fn.launches for name, fn in WRAPPERS.items()}

    for fn in WRAPPERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rows = kernel_bench.run(
        kernel_bench.OPS, BENCH_BS, torch.device("cuda"), g,
        depth=BENCH_DEPTH, iters=BENCH_ITERS,
        window_variants=BENCH_WINDOW_VARIANTS,
        global_variants=BENCH_GLOBAL_VARIANTS, emit=emit)
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    seconds = time.perf_counter() - t0

    before = dict.fromkeys(WRAPPERS, 0)
    for op in kernel_bench.OPS:  # the order the ops ran in
        got = {k: counts[op][k] - before[k] for k in WRAPPERS}
        want = {k: BENCH_LAUNCHES[op].get(k, 0) * n for k in WRAPPERS}
        if got != want:
            raise AssertionError(f"kernel_bench {op}: launches {got} differ "
                                 f"from the op's {want}")
        before = counts[op]
    if counts[kernel_bench.OPS[-1]] != launches:
        raise AssertionError("kernel_bench: launches outside the ops")
    for row in rows:
        if "ms" in row and not (math.isfinite(row["ms"]) and row["ms"] > 0
                                and row["ms_min"] > 0):
            raise AssertionError(f"kernel_bench: bad time in {row}")
    by = {(r["op"], r.get("variant")): r for r in rows}
    for op in ("wb", "gb"):
        if not by[op, "agreement"]["corr"] >= BENCH_CORR:
            raise AssertionError(f"kernel_bench {op}: the two paths disagree")
    if by["boundary", "kernel dewin+win pair"]["max_abs_diff"] != 0.0:
        raise AssertionError("kernel_bench boundary: the relayout round trip "
                             "changed values")
    log(f"phase 13 kernel_bench: {len(kernel_bench.OPS)} ops, {len(rows)} "
        f"rows at bs {BENCH_BS} in {seconds:.1f} s ({BENCH_ITERS} timed calls "
        f"after {kernel_bench.WARMUP} warm-ups each); every op's launch "
        f"counts exact, in all {launches}; wb corr "
        f"{by['wb', 'agreement']['corr']}, gb corr "
        f"{by['gb', 'agreement']['corr']} (bound {BENCH_CORR}), boundary "
        "round trip exact")

    # the encoder op once more with w=v3, counted on its own
    for fn in WRAPPERS.values():
        fn.launches = 0
    enc_rows = kernel_bench.run(("encoder",), BENCH_BS, torch.device("cuda"),
                                g, depth=BENCH_DEPTH, iters=BENCH_ITERS,
                                window_kernel="v3")
    got = {name: fn.launches for name, fn in WRAPPERS.items()}
    want = {k: BENCH_LAUNCHES["encoder"].get(k, 0) * n for k in WRAPPERS}
    log(f"phase 13 kernel_bench {json.dumps(enc_rows[0])}: launches "
        f"{ {k: v for k, v in got.items() if v} }; sam_window_attention_v3 "
        f"{got['sam_window_attention_v3']} times, as the JAX script: at "
        "SAM-1024 the preset's whole-block kernel K1 takes every window layer")
    if got != want or enc_rows[0]["variant"] != "w=v3,g=v6":
        raise AssertionError(f"kernel_bench encoder w=v3: launches {got} "
                             f"differ from {want}")
    return {"launches": {k: launches[k] + got[k] for k in WRAPPERS},
            "rows": rows + enc_rows}


def log2_score_max(q, k, rel_pos_h, rel_pos_w, side: int) -> float:
    """The largest log2-domain score of ``(G, S, hd)`` heads as the global
    kernels see it (v11 needs it below 128), over chunks of query rows."""
    G, S, hd = q.shape
    qs = (q.float() * (sam_flash.LOG2E / math.sqrt(hd))).to(q.dtype)
    bias = sam_flash.global_bias_rows(q, rel_pos_h, rel_pos_w, side)
    kt = k.transpose(1, 2)
    rows = max(1, sam_flash.MAX_PLAIN_SCORES // (G * S))
    best = -math.inf
    for r0 in range(0, S, rows):
        b = bias[:, r0:r0 + rows].float()
        s = matmul_f32(qs[:, r0:r0 + rows], kt).reshape(G, -1, side, side)
        s = s + b[..., :side, None] + b[..., None, side:]
        best = max(best, s.max().item())
    return best


def run_e2e_bench() -> dict:
    """Phases 14-16: the bench.py twin in process, DeepSeek-VL-1.3B at bs 4,
    SAM-1024 and S=672 at full width and depth, with the global kernel knob
    at v11 and at its default."""
    device = torch.device("cuda")
    knobs = e2e_bench.Knobs(global_kernel="v11")
    rows = {"v11": e2e_bench.run(BS, E2E_ITERS, knobs, device)}
    torch.cuda.empty_cache()
    check_e2e_row(14, rows["v11"], "v11")

    # phase 15: one batch through the v11, the v8 and the all-plain forward
    # of the same parameters (the seed gives run()'s again)
    model, cfg, params, batch = e2e_bench.build(BS, knobs, device)
    enc = cfg.sam.encoder
    cfg_v8 = dataclasses.replace(cfg, sam=dataclasses.replace(
        cfg.sam, encoder=dataclasses.replace(enc, global_kernel="v8")))
    scores = []
    real = sam_encoder.GLOBAL_KERNELS["v11"]

    def probed(q, k, v, rel_pos_h, rel_pos_w, side):
        scores.append(log2_score_max(q, k, rel_pos_h, rel_pos_w, side))
        return real(q, k, v, rel_pos_h, rel_pos_w, side)

    sam_encoder.GLOBAL_KERNELS["v11"] = probed
    try:
        with torch.no_grad():
            out = model.forward(params, cfg, batch)
    finally:
        sam_encoder.GLOBAL_KERNELS["v11"] = real
    log(f"phase 15 bench v11: largest log2-domain score of each global "
        f"layer {[round(x, 2) for x in scores]} (v11 needs every score "
        "below 128)")
    if len(scores) != 4 or not max(scores) < 128:
        raise AssertionError("v11's precondition does not hold on this path")
    with torch.no_grad():
        out_v8 = model.forward(params, cfg_v8, batch)
        for key in ("hidden", "coarse_logits", "sam_logits"):
            rel, corr = agreement(out[key], out_v8[key])
            log(f"phase 15 bench {key}: v11 vs v8 forward max_rel_err "
                f"{rel:.3e} corr {corr:.6f} (bound {FORWARD_CORR[key]})")
            if corr < FORWARD_CORR[key]:
                raise AssertionError(f"bench {key}: the v11 forward "
                                     "disagrees with the v8 forward")
    del out_v8

    def sam_embedding(cfg, plain, batch):
        return {"sam_embedding": tuple(sam_encoder.forward(
            params["frozen"]["sam_encoder"], c.sam.encoder,
            batch["sam_pixel_values"]) for c in (cfg, plain))}

    phase_compare(15, "bench v11", model.forward, params, cfg,
                  {"requests": [batch], "outs": [out]}, sam_embedding)
    del model, params, batch, out
    torch.cuda.empty_cache()

    rows["v8"] = e2e_bench.run(BS, E2E_ITERS, e2e_bench.Knobs(), device)
    torch.cuda.empty_cache()
    check_e2e_row(16, rows["v8"], "v8")
    return {"launches": {
        name: sum(r["launches"][name] * r["iters"] for r in rows.values())
        for name in WRAPPERS}, "rows": rows}


def randomize_sam_bqkv(blocks: list, g: torch.Generator) -> None:
    """Non-zero qkv biases in the SAM blocks (the init leaves them 0): the
    pad tokens of a padded grid then carry ``k = b_k`` and ``v = b_v`` that
    differ from a zero pad."""
    for bp in blocks:
        bp["bqkv"] = _randn(g, bp["bqkv"].shape, 0.1)


def run_sweep(g: torch.Generator) -> dict:
    """Phases 17-18: the size sweep in process at the two padded grids, then
    the kernel forward against the all-plain forward at each size."""
    device = torch.device("cuda")
    rows = schedule_bench.run(SWEEP_SIZES, (BS,), SWEEP_ITERS,
                              e2e_bench.Knobs(), device)
    want = {name: SWEEP_LAUNCHES.get(name, 0) for name in WRAPPERS}
    for row, size in zip(rows, SWEEP_SIZES):
        log(f"phase 17 schedule_bench {json.dumps(row)}")
        if row.get("launches") != want:
            raise AssertionError(f"schedule_bench SAM-{size}: launches per "
                                 f"forward differ from {want}")
        if (row["sam_size"], row["bs"], row["iters"], row["family"],
                row["preset"], row["global_kernel"]) != (
                    size, BS, SWEEP_ITERS, "deepseek_vl", "1_3b", "v8"):
            raise AssertionError(f"schedule_bench SAM-{size}: wrong settings "
                                 "in the row")
        for r in (row, row["plain"]):
            if not (math.isfinite(r["value"]) and r["value"] > 0
                    and 0 < r["ms_min"] <= r["ms_mean"] <= r["ms_max"]):
                raise AssertionError(f"schedule_bench SAM-{size}: bad time "
                                     f"in {r}")
    log(f"phase 17 schedule_bench {json.dumps(rows[-1])}")
    best = rows[-1]["schedule_best_img_per_s"]
    if best != {str(size): row["img_per_s"]
                for row, size in zip(rows, SWEEP_SIZES)}:
        raise AssertionError("schedule_bench: the summary is not the best "
                             "row per size")

    for size in SWEEP_SIZES:
        model, cfg, params, batch = e2e_bench.build(
            BS, e2e_bench.Knobs(sam_size=size), device)
        randomize_sam_bqkv(params["frozen"]["sam_encoder"]["blocks"], g)
        with torch.no_grad():
            out = model.forward(params, cfg, batch)

        def sam_embedding(cfg, plain, batch, params=params):
            return {"sam_embedding": tuple(sam_encoder.forward(
                params["frozen"]["sam_encoder"], c.sam.encoder,
                batch["sam_pixel_values"]) for c in (cfg, plain))}

        phase_compare(18, f"schedule_bench SAM-{size}", model.forward,
                      params, cfg, {"requests": [batch], "outs": [out]},
                      sam_embedding)
        del model, params, batch, out
        torch.cuda.empty_cache()
    return {"launches": {
        name: sum(r["launches"][name] * r["iters"] for r in rows[:-1])
        for name in WRAPPERS}, "rows": rows}


def run_window_variants(g: torch.Generator) -> dict:
    """Phase 19: the SAM ViT-L encoder alone at full width and depth, SAM-768
    at bs 4 (a 48 x 48 grid padded to 56: 16 windows an image), with
    non-zero qkv biases and rel-pos tables, through each window kernel
    name."""
    full = registry.with_sam_size(deepseek_vl.deepseek_vl_1_3b(), VARIANT_SAM)
    base, plain = full.sam.encoder, registry.plain_config(full).sam.encoder
    params = sam_encoder.init_params(base, g, "cuda")
    randomize_sam_bqkv(params["blocks"], g)
    for bp in params["blocks"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            bp[key] = _randn(g, bp[key].shape, 0.05)
    pixels = _randn(g, (BS, VARIANT_SAM, VARIANT_SAM, 3))
    launches = dict.fromkeys(WRAPPERS, 0)
    with torch.no_grad():
        ref_plain = sam_encoder.forward(params, plain, pixels)
        embeddings = {}
        for name in ("v9", "v1", "v6", "v7", "v8", "v2") + NEW_WINDOWS:
            cfg = dataclasses.replace(base, window_kernel=name)
            sam_encoder.forward(params, cfg, pixels)  # warm-up
            for fn in WRAPPERS.values():
                fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            embeddings[name] = sam_encoder.forward(params, cfg, pixels)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            got = {k: fn.launches for k, fn in WRAPPERS.items() if fn.launches}
            want = {WINDOW_WRAPPER[name]: 20, "sam_global_attention_v8": 4,
                    "fused_ln_qkv": 24, "fused_proj_ln_mlp": 24}
            log(f"phase 19 encoder window_kernel={name}: launches {got} "
                f"(expected {want}), {ms:.1f} ms, peak memory {peak_gb:.2f} "
                "GB")
            if got != want:
                raise AssertionError(f"window_kernel={name}: launch counts "
                                     "differ from the encoder's")
            for k, n in got.items():
                launches[k] += n
            for other, ref in (("v9", embeddings["v9"]),
                               ("all-plain", ref_plain)):
                rel, corr = agreement(embeddings[name], ref)
                log(f"phase 19 encoder window_kernel={name}: embedding vs "
                    f"the {other} encoder max_rel_err {rel:.3e} corr "
                    f"{corr:.6f} (bound {FORWARD_CORR['sam_embedding']})")
                if corr < FORWARD_CORR["sam_embedding"]:
                    raise AssertionError(
                        f"window_kernel={name}: the embedding disagrees "
                        f"with the {other} encoder's")
    return {"launches": launches}


def _with_env(env: dict, fn):
    """``fn()`` with ``env`` laid over ``os.environ``, which is restored."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def run_family_matrix() -> dict:
    """Phase 20: the family matrix over the two families that had not run on
    a card and the mgm family's flagship, one child process of the bench.py
    twin per point, and HPT-Air-1.5's int8_llm point (the W8A8 decoder).
    The counts are the children's own (each child
    sets them to 0 after its warm-up forwards and reads them after the timed
    ones); this process launches nothing here."""
    bench_keys = ("BENCH_FAMILY", "BENCH_PRESET", "BENCH_SAM_SIZE", "BENCH_BS",
                  "BENCH_SEQ", "BENCH_GLOBAL_BLOCK", "BENCH_GLOBAL_KERNEL",
                  "BENCH_QUANT_LLM")
    clean = {k: os.environ.pop(k) for k in bench_keys if k in os.environ}
    rows, launches = {}, dict.fromkeys(WRAPPERS, 0)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = str(pathlib.Path(tmp) / "rows.json")
            common = ["--out", out, "--timeout", str(FAMILY_TIMEOUT)]
            for family, env, preset, _ in FAMILY_POINTS:
                t0 = time.perf_counter()
                result = _with_env(
                    {**env, "BENCH_ITERS": str(FAMILY_ITERS)},
                    lambda: bench_families.main(
                        ["--families", family, *common]))
                row = result["rows"][-1]
                log(f"phase 20 bench_families {json.dumps(row)} "
                    f"({time.perf_counter() - t0:.1f} s with the child's "
                    "start and parameters)")
                name = env["BENCH_GLOBAL_KERNEL"]
                want = {k: family_launches(name).get(k, 0) for k in WRAPPERS}
                if "error" in row or row["mode"] != "bf16":
                    raise AssertionError(f"bench_families {family}: no bf16 "
                                         f"row without error: {row}")
                if row["launches"] != want:
                    raise AssertionError(f"bench_families {family}: launches "
                                         f"per forward differ from {want}")
                if (row["family"], row["preset"], row["bs"], row["sam_size"],
                        row["iters"], row["global_kernel"]) != (
                            family, preset, BS, 1024, FAMILY_ITERS, name):
                    raise AssertionError(f"bench_families {family}: wrong "
                                         "settings in the row")
                for r in (row, row["plain"]):
                    if not (math.isfinite(r["value"]) and r["value"] > 0 and
                            0 < r["ms_min"] <= r["ms_mean"] <= r["ms_max"]):
                        raise AssertionError(f"bench_families {family}: bad "
                                             f"time in {r}")
                rows[family] = row
                for k in WRAPPERS:
                    launches[k] += row["launches"][k] * row["iters"]
            # the mgm family's flagship (Gemma-2B) at the default v8
            t0 = time.perf_counter()
            mgm = _with_env({"BENCH_ITERS": str(FAMILY_ITERS)},
                            lambda: bench_families.main(
                                ["--families", "mgm", *common]))
            row = mgm["rows"][-1]
            log(f"phase 20 bench_families {json.dumps(row)} "
                f"({time.perf_counter() - t0:.1f} s with the child's start "
                "and parameters)")
            want = {k: EXPECTED_LAUNCHES["mgm_gemma_2b"].get(k, 0)
                    for k in WRAPPERS}
            if "error" in row or row["mode"] != "bf16" or (
                    row["family"], row["preset"], row["bs"], row["sam_size"],
                    row["iters"], row["global_kernel"]) != (
                        "mgm", "gemma_2b", BS, 1024, FAMILY_ITERS, "v8"):
                raise AssertionError(f"bench_families mgm: no bf16 row of "
                                     f"gemma_2b without error: {row}")
            if row["launches"] != want:
                raise AssertionError("bench_families mgm: launches per "
                                     f"forward differ from {want}")
            for r in (row, row["plain"]):
                if not (math.isfinite(r["value"]) and r["value"] > 0 and
                        0 < r["ms_min"] <= r["ms_mean"] <= r["ms_max"]):
                    raise AssertionError(f"bench_families mgm: bad time in "
                                         f"{r}")
            rows["mgm"] = row
            for k in WRAPPERS:
                launches[k] += row["launches"][k] * row["iters"]
            # the int8_llm point (BENCH_QUANT_LLM=1) of HPT-Air-1.5 gives
            # its row; phase 35 sets it beside the bf16 row
            quant = bench_families.run_one(
                "hpt", "int8_llm", {**bench_families.PLAN["hpt"][-1][1],
                                    "BENCH_ITERS": str(FAMILY_ITERS)},
                1024, FAMILY_TIMEOUT)
            log(f"phase 20 bench_families {json.dumps(quant)}")
            if "error" in quant or (quant["family"], quant["mode"],
                                    quant["preset"]) != (
                                        "hpt", "int8_llm", "air_1_5"):
                raise AssertionError("bench_families: the int8_llm row of "
                                     f"HPT-Air-1.5 failed: {quant}")
            rows["hpt_int8_llm"] = quant
            for k in WRAPPERS:
                launches[k] += quant["launches"][k] * quant["iters"]
            kept = [(r["family"], r["mode"]) for r in mgm["rows"]]
            if kept != [("llava", "bf16"), ("hpt", "bf16"), ("mgm", "bf16")]:
                raise AssertionError(f"bench_families: --out holds {kept}")
    finally:
        os.environ.update(clean)
    return {"launches": launches, "rows": rows}


def compare_families() -> dict:
    """Phase 21: both families built in process (the seed gives the
    children's parameters again), one batch through the forward with each of
    the global kernels v1, v2 and v4, the counts at 0 just before and read
    just after, against the all-plain forward of the same weights."""
    device = torch.device("cuda")
    launches = dict.fromkeys(WRAPPERS, 0)
    for family, env, preset, _ in FAMILY_POINTS:
        knobs = e2e_bench.Knobs(family=family, preset=env.get("BENCH_PRESET"))
        model, cfg, params, batch = e2e_bench.build(BS, knobs, device)
        enc_params = params["frozen"]["sam_encoder"]
        plain = registry.plain_config(cfg)
        with torch.no_grad():
            ref = model.forward(params, plain, batch)
            ref["sam_embedding"] = sam_encoder.forward(
                enc_params, plain.sam.encoder, batch["sam_pixel_values"])
            for name in NEW_GLOBALS:
                cfg_n = dataclasses.replace(cfg, sam=dataclasses.replace(
                    cfg.sam, encoder=dataclasses.replace(
                        cfg.sam.encoder, global_kernel=name)))
                for fn in WRAPPERS.values():
                    fn.launches = 0
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model.forward(params, cfg_n, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                got = {k: fn.launches for k, fn in WRAPPERS.items()}
                want = {k: family_launches(name).get(k, 0) for k in WRAPPERS}
                log(f"phase 21 {family} {preset} global_kernel={name}: one "
                    f"bs-{BS} forward {ms:.1f} ms, peak memory "
                    f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
                    f"launches { {k: n for k, n in got.items() if n} }")
                if got != want:
                    raise AssertionError(f"{family} global_kernel={name}: "
                                         f"launches differ from {want}")
                for k, n in got.items():
                    launches[k] += n
                out["sam_embedding"] = sam_encoder.forward(
                    enc_params, cfg_n.sam.encoder, batch["sam_pixel_values"])
                for key in ("sam_embedding", "hidden", "coarse_logits",
                            "sam_logits"):
                    rel, corr = agreement(out[key], ref[key])
                    log(f"phase 21 {family} {preset} global_kernel={name} "
                        f"{key}: kernel vs plain forward max_rel_err "
                        f"{rel:.3e} corr {corr:.6f} (bound "
                        f"{FORWARD_CORR[key]})")
                    if corr < FORWARD_CORR[key]:
                        raise AssertionError(
                            f"{family} global_kernel={name} {key}: kernel "
                            "forward disagrees with the plain forward")
                del out
        del model, params, batch, ref
        torch.cuda.empty_cache()
    return {"launches": launches}


def eval_spec(cfg) -> BatchSpec:
    """The eval scripts' batch spec for DeepSeek-VL, built as
    flmm_tpu/registry.py:179-187 builds it: no alignment (the image block
    starts at 5 and the decoder captures eagerly), the config's img_start,
    SAM sizes and input size, the deepseek resize rule."""
    return BatchSpec(
        seq_len=EVAL_SEQ, max_masks=EVAL_MASKS,
        coarse_hw=registry.get_coarse_hw(cfg), align_image_block=None,
        expected_img_start=cfg.img_start, sam_size=cfg.sam.encoder.img_size,
        prompt_size=cfg.sam.prompt_size,
        processor=ProcessorConfig(
            size=cfg.input_size,
            size_rule=registry.FAMILY_SIZE_RULES["deepseek_vl"]))


def eval_loop(params, cfg, samples, acc, score, predict=None,
              builds: dict | None = None) -> dict:
    """``run_eval`` over ``samples`` with every launch count at 0 just
    before and read just after; the forward's SAM logits of each batch are
    kept.  ``predict`` replaces the forward; with ``builds`` the batch
    builds go through ``replaying(builds)``.  Returns the results, the
    logits, the launches, the buckets used and the times: the loop's wall
    time, the forwards' device time (CUDA events, after the batch's copy to
    the card) and their wall time (the copy included), the batch builder's
    host time."""
    run = {"logits": [], "forward_ms": [], "forward_s": 0.0, "build_s": 0.0,
           "seq": [], "replayed": 0}

    def timed_build(batch_samples, spec):
        t0 = time.perf_counter()
        batch = build_batch(batch_samples, spec)
        run["build_s"] += time.perf_counter() - t0
        return batch

    replayed = (timed_build if builds is None
                else replaying(builds, run)(timed_build))

    def build(batch_samples, spec):
        run["seq"].append(spec.seq_len)
        return replayed(batch_samples, spec)

    def forward(batch):
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if predict is None:
            batch = from_jax(batch, "cuda")
            start.record()
            out = grounding.forward(params, cfg, batch)["sam_logits"]
        else:
            start.record()
            out = predict(batch)
        end.record()
        torch.cuda.synchronize()
        run["forward_s"] += time.perf_counter() - t0
        run["forward_ms"].append(start.elapsed_time(end))
        run["logits"].append(out)
        return out

    for fn in WRAPPERS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        result = runner.run_eval(samples, forward, eval_spec(cfg), EVAL_BS,
                                 acc, score, seq_len_buckets=EVAL_BUCKETS,
                                 batch_builder=build).results()
    torch.cuda.synchronize()
    run["wall_s"] = time.perf_counter() - t0
    run["launches"] = {name: fn.launches for name, fn in WRAPPERS.items()}
    run["results"] = result
    if not all(math.isfinite(v) for v in result.values()):
        raise AssertionError(f"eval: non-finite results {result}")
    return run


def _check_eval(label, run, n_masks, per_forward) -> None:
    """Every valid mask scored; launches per forward as ``per_forward``."""
    batches = len(run["forward_ms"])
    want = {k: per_forward.get(k, 0) * batches for k in WRAPPERS}
    log(f"phase 22 eval {label}: {json.dumps(run['results'])}; {batches} "
        f"batches at buckets {run['seq']}; launches "
        f"{ {k: n for k, n in run['launches'].items() if n} }")
    if run["results"]["n"] != n_masks:
        raise AssertionError(f"eval {label}: {run['results']['n']} masks "
                             f"scored, {n_masks} valid")
    if run["launches"] != want:
        raise AssertionError(f"eval {label}: launches differ from {want}")


def _logits_agree(label, got, want) -> None:
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        rel, corr = agreement(a, b)
        log(f"phase 22 eval {label} batch {i}: sam_logits max_rel_err "
            f"{rel:.3e} corr {corr:.6f} (bound {FORWARD_CORR['sam_logits']})")
        if corr < FORWARD_CORR["sam_logits"]:
            raise AssertionError(f"eval {label}: the logits disagree")


def run_eval_phase(g: torch.Generator, card: str) -> dict:
    """Phase 22: the eval loop at DeepSeek-VL-1.3B over the synthetic
    sample stream, at SAM-1024 and, through the window kernels, at
    SAM-768."""
    cfg = deepseek_vl.deepseek_vl_1_3b()
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")  # the forward never uses it
    randomize_rel_pos(params, g)
    samples = synthetic_samples(cfg, n=EVAL_N, seed=EVAL_SEED,
                                max_masks=EVAL_MASKS,
                                caption_tokens=EVAL_CAPTION)
    n_masks = sum(min(len(s["spans"]), EVAL_MASKS) for s in samples)
    launches = dict.fromkeys(WRAPPERS, 0)
    with torch.no_grad():  # warm-up: the first batch's forward
        warm = build_batch(samples[:EVAL_BS], eval_spec(cfg))
        warm.pop("infos")
        grounding.forward(params, cfg, from_jax(warm, "cuda"))
    del warm

    torch.cuda.reset_peak_memory_stats()
    # the all-plain and the ground-truth pass replay the first pass's
    # batches; the PNG pass, whose busy share is read, builds its own
    builds = {}
    ref = eval_loop(params, cfg, samples, metrics.RefSegAccumulator,
                    runner.refcoco_score, builds=builds)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_eval("refcoco SAM-1024", ref, n_masks,
                EXPECTED_LAUNCHES["deepseek_vl_1_3b"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        png = eval_loop(params, cfg, samples, metrics.PNGAccumulator,
                        runner.png_score)
    busy_ms = trace.profile_breakdown(prof.events())["busy_s"] * 1e3
    del prof
    _check_eval("png SAM-1024", png, n_masks,
                EXPECTED_LAUNCHES["deepseek_vl_1_3b"])
    for run in (ref, png):
        for k in WRAPPERS:
            launches[k] += run["launches"][k]
    plain = eval_loop(params, registry.plain_config(cfg), samples,
                      metrics.RefSegAccumulator, runner.refcoco_score,
                      builds=builds)
    _check_eval("refcoco SAM-1024 all-plain forward", plain, n_masks, {})
    _logits_agree("SAM-1024 kernel vs plain forward", ref["logits"],
                  plain["logits"])
    del plain

    def gt_logits(batch):
        """The ground truth as +-8 logits (tests/test_eval.py's mock)."""
        gt = torch.from_numpy(batch["gt_sam"]).cuda()
        return torch.where(gt > 0.5, 8.0, -8.0)

    gt = eval_loop(params, cfg, samples, metrics.RefSegAccumulator,
                   runner.refcoco_score, predict=gt_logits, builds=builds)
    _check_eval("refcoco SAM-1024 ground truth as logits", gt, n_masks, {})
    if not min(gt["results"]["cIoU"], gt["results"]["mIoU"]) > EVAL_GT_MIN:
        raise AssertionError("eval: the ground truth as logits scores "
                             f"{gt['results']}, not above {EVAL_GT_MIN}")
    del params, gt, builds
    torch.cuda.empty_cache()

    batches = len(ref["forward_ms"])
    stats = {
        "forward_ms": sum(ref["forward_ms"]) / batches,
        "build_ms": ref["build_s"] * 1e3 / batches,
        "host_ms": (ref["wall_s"] - ref["forward_s"]) * 1e3 / batches,
        "copy_ms": (ref["forward_s"] * 1e3 - sum(ref["forward_ms"]))
        / batches,
        "samples_per_s": EVAL_N / ref["wall_s"],
        "peak_gb": peak_gb, "busy_share": busy_ms / (png["wall_s"] * 1e3)}
    log(f"phase 22 eval SAM-1024 ({card}): {EVAL_N} samples in {batches} "
        f"batches of {EVAL_BS}: forward {stats['forward_ms']:.1f} ms a batch "
        f"(CUDA events), host {stats['host_ms']:.1f} ms a batch (of it the "
        f"batch builder's collate and preprocessing {stats['build_ms']:.1f} "
        f"ms; the rest the masks' resize, their copy to the host and the "
        f"scoring), "
        f"the batch's copy to the card and the forward's launch "
        f"{stats['copy_ms']:.1f} ms, {stats['samples_per_s']:.2f} samples/s, "
        f"peak "
        f"{peak_gb:.2f} GB; the device busy {busy_ms:.1f} ms of the PNG "
        f"loop's {png['wall_s'] * 1e3:.1f} ms under the profiler "
        f"({stats['busy_share']:.1%})")

    # SAM-768: one batch of the first samples that fit the shortest bucket,
    # through each window kernel
    cfg = registry.with_sam_size(cfg, VARIANT_SAM)
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")
    randomize_rel_pos(params, g)
    randomize_sam_bqkv(params["frozen"]["sam_encoder"]["blocks"], g)
    short = [s for s in samples
             if len(s["input_ids"]) <= EVAL_BUCKETS[0]][:EVAL_BS]
    n_short = sum(min(len(s["spans"]), EVAL_MASKS) for s in short)
    runs, builds = {}, {}
    for name in EVAL_WINDOWS:
        cfg_n = dataclasses.replace(cfg, sam=dataclasses.replace(
            cfg.sam, encoder=dataclasses.replace(cfg.sam.encoder,
                                                 window_kernel=name)))
        runs[name] = eval_loop(params, cfg_n, short,
                               metrics.RefSegAccumulator,
                               runner.refcoco_score, builds=builds)
        _check_eval(f"refcoco SAM-{VARIANT_SAM} window_kernel={name}",
                    runs[name], n_short,
                    {**SWEEP_LAUNCHES, "sam_window_attention_v9": 0,
                     WINDOW_WRAPPER[name]: 20})
        for k in WRAPPERS:
            launches[k] += runs[name]["launches"][k]
    for name in NEW_WINDOWS:
        _logits_agree(f"SAM-{VARIANT_SAM} window_kernel={name} vs v9",
                      runs[name]["logits"], runs["v9"]["logits"])
    del params, runs
    torch.cuda.empty_cache()
    return {"launches": launches, "stats": stats}


class WordTokenizer:
    """Word-level stand-in for DeepSeek-VL's tokenizer (the machine with the
    card has no tokenizers or transformers): one id per whitespace-separated
    word.  The special words take DeepSeek-LLM's ids (BOS 100000, the stop
    word 100001, ``<image_placeholder>`` 100015), the words of
    ``GEN_WORDS`` 1000 up, any other word a CRC32 below 100000; every id
    decodes to one word, so a random model's answer reads as words."""

    BOS = 100000
    SPECIAL = {"<｜end▁of▁sentence｜>": 100001, "<image_placeholder>": 100015}
    VOCAB = 100000  # a word's id is below this unless it is a special word

    def encode(self, text: str, add_special_tokens: bool = False) -> list:
        ids = [self.BOS] if add_special_tokens else []
        text = text.replace("<image_placeholder>", " <image_placeholder> ")
        for w in text.split():
            if w in self.SPECIAL:
                ids.append(self.SPECIAL[w])
            elif w in GEN_WORDS:
                ids.append(1000 + GEN_WORDS.index(w))
            else:
                ids.append(1000 + zlib.crc32(w.encode())
                           % (self.VOCAB - 1000))
        return ids

    def decode(self, ids) -> str:
        names = {v: k for k, v in self.SPECIAL.items()}
        return " ".join(names.get(int(i), GEN_WORDS[int(i) % len(GEN_WORDS)])
                        for i in ids)


class NounTokenizer(WordTokenizer):
    """The word-level stand-in with every id but the special ones decoding
    to a noun of ``GEN_WORDS``: a random model's answer repeats one token
    (phase 25's model answers "on on on ..." through ``WordTokenizer``), and
    this way it holds a noun phrase for ``grounded_conversation`` to
    ground."""

    NOUNS = GEN_WORDS[GEN_WORDS.index("dog"):GEN_WORDS.index("bottle") + 1]

    def decode(self, ids) -> str:
        names = {v: k for k, v in self.SPECIAL.items()}
        return " ".join(names.get(int(i), self.NOUNS[int(i) % len(self.NOUNS)])
                        for i in ids)


def _counted(fn) -> tuple:
    """``fn()`` with every launch count at 0 just before and read just
    after: ``(result, host ms, launches)``."""
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, {name: w.launches for name, w in WRAPPERS.items()}


def _check_launches(call: str, launches: dict, total: dict,
                    table: dict = GEN_LAUNCHES, phase: int = 24,
                    what: str = "generation") -> None:
    want = {name: table[call].get(name, 0) for name in WRAPPERS}
    log(f"phase {phase} {what} {call}: launches "
        f"{ {k: v for k, v in launches.items() if v} } (expected "
        f"{ {k: v for k, v in want.items() if v} }, every other kernel 0)")
    if launches != want:
        raise AssertionError(f"{what} {call}: kernel launch counts "
                             "differ from the path's")
    for name, n in launches.items():
        total[name] += n


def _answer_traced(grounder, image, max_new: int | None = None) -> tuple:
    """One ``answer`` request through the entry point.  Returns its result,
    the dict its ``_generate`` returned (with the arguments it took under
    'args') and CUDA-event ms: 'call' the whole request, 'before' the part
    ahead of ``_generate`` (image preparation on the host, tokenisation,
    the tower), 'generate' the prefill and decode.  The spans hold the
    host's gaps."""
    seen = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def spy(*args):
        ev[1].record()
        result = type(grounder)._generate(grounder, *args)
        ev[2].record()
        seen.update(result, args=args)
        return result

    grounder._generate = spy
    try:
        ev[0].record()
        out = grounder.answer(image, GEN_QUESTION, max_new_tokens=max_new)
        ev[3].record()
    finally:
        del grounder._generate
    torch.cuda.synchronize()
    return out, seen, {"call": ev[0].elapsed_time(ev[3]),
                       "before": ev[0].elapsed_time(ev[1]),
                       "generate": ev[1].elapsed_time(ev[2])}


def _agree(label: str, got, want, bound: float,
           pair: str = "the kernel path vs the plain path",
           phase: int = 24, what: str = "generation") -> None:
    rel, corr = agreement(torch.as_tensor(got), torch.as_tensor(want))
    log(f"phase {phase} {what} {label}: {pair} max_rel_err {rel:.3e} corr "
        f"{corr:.6f} (bound {bound})")
    if corr < bound:
        raise AssertionError(f"{what} {label}: {pair} disagree")


def run_generation(card: str) -> dict:
    """Phase 24: DeepSeek-VL-1.3B (lm_head kept) through the grounder API:
    answer, ground, visual_cot_v1 and visual_cot_v2, each with exact launch
    counts, against the all-plain grounder on the same weights.  Its peak
    memory is counted above what the earlier phases leave allocated."""
    base = torch.cuda.memory_allocated()
    cfg = deepseek_vl.deepseek_vl_1_3b()
    g = torch.Generator(device="cuda").manual_seed(GEN_SEED)
    params = grounding.init_params(cfg, g, "cuda")
    randomize_rel_pos(params, g)
    tokenizer = WordTokenizer()
    kernel = generation.make_grounder("deepseek_vl", cfg, params, tokenizer,
                                      max_new_tokens=GEN_MAX_NEW)
    plain = generation.make_grounder(
        "deepseek_vl", registry.plain_config(cfg), params, tokenizer,
        max_new_tokens=GEN_MAX_NEW)
    rng = np.random.default_rng(GEN_SEED)
    images = [rng.integers(0, 256, (h, w, 3), np.uint8)
              for h, w in GEN_IMAGES]
    total = dict.fromkeys(WRAPPERS, 0)
    L, H = cfg.llm.num_layers, cfg.llm.num_heads
    n_img = cfg.num_img_tokens

    warm = kernel.answer(images[1], GEN_QUESTION, max_new_tokens=2)
    kernel.ground(warm, [(0, 1)])
    del warm
    torch.cuda.reset_peak_memory_stats()

    # answer: 32 new tokens with the per-step capture, then the 1-token
    # request (its _generate: the prefill and the first step); decode ms a
    # token is the difference of the two _generate spans over the other steps
    (out, gen, ev_ms), answer_ms, launches = _counted(
        lambda: _answer_traced(kernel, images[0]))
    _check_launches("answer", launches, total)
    (_, _, first_ev), _, launches = _counted(
        lambda: _answer_traced(kernel, images[0], 1))
    _check_launches("answer", launches, total)
    T = len(out["output_ids"])
    maps, hidden = out["attention_maps"], out["hidden_states"]
    if not (1 <= T <= GEN_MAX_NEW and tuple(maps.shape) == (L, H, T, n_img)
            and tuple(hidden.shape) == (T, cfg.llm.hidden_size)
            and torch.isfinite(maps).all() and torch.isfinite(hidden).all()
            and ((maps.sum(-1) - 1.0).abs() < 1.0).all()):
        raise AssertionError("generation answer: wrong shapes or values")
    if not (int(out["output_ids"].max()) < cfg.llm.vocab_size
            and out["output_ids"].min() >= 0):
        raise AssertionError("generation answer: token ids out of range")
    log(f"phase 24 generation answer: {T} tokens, {out['output_text'][:80]!r}"
        f"...; attention maps {tuple(maps.shape)}, hidden "
        f"{tuple(hidden.shape)}, finite")

    # the bf16 KV-cache decode against the decoder's full forward over the
    # grown sequence: the first steps' and the last step's rows
    llm_p = params["frozen"]["llm"]
    embeds, img_start = gen["args"][0], gen["args"][1]
    S = embeds.shape[0]
    lw = torch.softmax(params["trainable"]["text_layer_weights"], 0)
    ids = torch.as_tensor(out["output_ids"], device="cuda").long()
    with torch.no_grad():
        for t in sorted({0, 1, T - 1} & set(range(T))):
            # step t feeds token t at position S + t
            grown = torch.cat([embeds, llm_decoder.embed_tokens(
                llm_p, cfg.llm, ids[:t + 1]).to(embeds.dtype)])
            full = llm_decoder.forward_capture(
                llm_p, cfg.llm, grown[None],
                torch.ones((1, S + t + 1), dtype=torch.bool, device="cuda"),
                img_start, n_img, layer_weights=lw)
            pair = "the KV-cache decode vs the full forward"
            _agree(f"decode step {t} rows (L, H, n_img)", gen["attn"][t],
                   full["attn"][0][:, :, S + t], FORWARD_CORR["attn"], pair)
            _agree(f"decode step {t} hidden", gen["hidden"][t],
                   full["hidden"][0, S + t], FORWARD_CORR["hidden"], pair)
            del full

    # the same requests on the all-plain grounder: prefill capture, prompt
    # hidden and first-step logits side by side
    (pout, pgen, plain_ev), plain_answer_ms, _ = _counted(
        lambda: _answer_traced(plain, images[0]))
    _, _, plain_first_ev = _answer_traced(plain, images[0], 1)
    _agree("prefill capture (L, H, S, n_img)", gen["prompt_attn"],
           pgen["prompt_attn"], FORWARD_CORR["attn"])
    _agree("prompt hidden", gen["prompt_hidden"], pgen["prompt_hidden"],
           FORWARD_CORR["hidden"])
    _agree("first-step logits",
           llm_decoder.logits(llm_p, cfg.llm, gen["last_hidden"]),
           llm_decoder.logits(llm_p, cfg.llm, pgen["last_hidden"]), 0.99)
    pT = len(pout["output_ids"])
    same = int(np.argmin(np.append(
        out["output_ids"][:pT] == pout["output_ids"][:T], False)))
    log(f"phase 24 generation tokens: the plain path's agree with the "
        f"kernel path's for the first {same} of {min(T, pT)} (greedy argmax "
        f"over {cfg.llm.vocab_size} bf16 logits of a random model may flip "
        "on rounding)")
    first_ms, prefill_ms = first_ev["call"], first_ev["generate"]
    decode_ms = ((ev_ms["generate"] - prefill_ms) / (T - 1) if T > 1
                 else math.nan)
    plain_prefill_ms = plain_first_ev["generate"]
    plain_decode_ms = ((plain_ev["generate"] - plain_prefill_ms) / (pT - 1)
                       if pT > 1 else math.nan)

    # the same answer under the profiler: the device's busy share of the
    # request and its device operations a generated token
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernel.answer(images[0], GEN_QUESTION)
        torch.cuda.synchronize()
    parts = trace.profile_breakdown(prof.events())
    busy_ms, window_ms = parts["busy_s"] * 1e3, parts["window_s"] * 1e3
    device_ops = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and e.name != "Command Buffer Full")
    del prof
    log(f"phase 24 generation answer under the profiler: device busy "
        f"{busy_ms:.1f} of {window_ms:.1f} ms ({busy_ms / window_ms:.1%}), "
        f"{device_ops} device operations, {device_ops / T:.0f} a generated "
        "token")

    # ground: two token spans of the answer and one noun chunk's, if any
    half = max(1, T // 2)
    spans = [(0, half), (half, T)] if T > 1 else [(0, 1)]
    chunk = None
    for s_char, e_char, phrase in noun_chunks(out["output_text"]):
        span = char_span_to_token_span(tokenizer, list(out["output_ids"]),
                                       (s_char, e_char))
        if span:
            chunk = (phrase, span)
            spans.append(span)
            break
    log("phase 24 generation noun chunk: " + (
        f"{chunk[0]!r} at tokens {chunk[1]}" if chunk else
        "none in the answer's text (random weights); only the two token "
        "spans are grounded"))
    (coarse, masks), ground_ms, launches = _counted(
        lambda: kernel.ground(out, spans))
    _check_launches("ground", launches, total)
    h0, w0 = GEN_IMAGES[0]
    if (masks.shape != (len(spans), h0, w0) or masks.dtype != np.uint8
            or not torch.isfinite(coarse).all()):
        raise AssertionError("generation ground: wrong masks or logits")
    log(f"phase 24 generation ground: {len(spans)} spans {spans}, masks "
        f"{masks.shape}, mask pixels {masks.reshape(len(spans), -1).sum(1)}")
    # one answer's maps on both grounders: the SAM encoder's K1-K4 alone
    # differ (the coarse logits come from a plain U-Net on equal maps)
    got = kernel.ground_logits(out, spans)
    want = plain.ground_logits(out, spans)
    _agree("ground SAM low-res logits (one answer's maps)", got[1], want[1],
           FORWARD_CORR["sam_logits"])
    # each grounder's own prompt capture over the question's tokens, as
    # visual_cot_v2 grounds it: the coarse logits carry the tower's K3 / K4
    q_span = [(img_start + n_img, S)]
    got = kernel.ground_logits({**out, "attention_maps": gen["prompt_attn"],
                                "hidden_states": gen["prompt_hidden"]},
                               q_span)
    want = plain.ground_logits({**out, "attention_maps": pgen["prompt_attn"],
                                "hidden_states": pgen["prompt_hidden"]},
                               q_span)
    _agree(f"ground coarse logits (each path's prompt capture, tokens "
           f"{q_span[0]})", got[0], want[0], FORWARD_CORR["attn"])
    _agree("ground SAM low-res logits (each path's prompt capture)", got[1],
           want[1], FORWARD_CORR["sam_logits"])
    del got, want, coarse, gen, pgen

    cot = {}
    for version, image in (("v1", images[0]), ("v2", images[1])):
        (thought, bbox, final, mask), ms, launches = _counted(
            lambda: getattr(kernel, f"visual_cot_{version}")(
                image, GEN_QUESTION))
        _check_launches(f"visual_cot_{version}", launches, total)
        h, w = image.shape[:2]
        x0, y0, x1, y1 = bbox
        if not (isinstance(final, str) and isinstance(thought, str)
                and 0 <= x0 < x1 <= w and 0 <= y0 < y1 <= h
                and mask.shape == (h, w)):
            raise AssertionError(f"generation visual_cot_{version}: bad "
                                 "result")
        cot[version] = ms
        log(f"phase 24 generation visual_cot_{version} on {h} x {w}: "
            f"thought {thought[:40]!r}, box {bbox}, answer "
            f"{len(final.split())} words, {ms:.1f} ms")
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    stats = {
        "first_token_ms": first_ms,
        "prepare_and_tower_ms": first_ev["before"],
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "answer_ms": answer_ms, "tokens_per_s": T * 1e3 / answer_ms,
        "ground_ms": ground_ms, "cot_v1_ms": cot["v1"],
        "cot_v2_ms": cot["v2"], "peak_gb": peak_gb,
        "plain_first_token_ms": plain_first_ev["call"],
        "plain_prefill_ms": plain_prefill_ms,
        "plain_decode_ms_per_token": plain_decode_ms,
        "plain_answer_ms": plain_answer_ms,
        "busy_share": busy_ms / window_ms, "device_ops_per_token":
            device_ops / T}
    log(f"phase 24 generation timing ({card}), CUDA events: first token "
        f"{first_ms:.1f} ms (answer with 1 new token) = image preparation "
        f"on the host, tokenisation and the tower {first_ev['before']:.1f} "
        f"ms + prefill and the first step {prefill_ms:.1f} ms; decode "
        f"{decode_ms:.2f} ms a token (the {T}-token answer's _generate "
        f"{ev_ms['generate']:.1f} ms less the prefill's, over {T - 1} "
        f"steps); answer {answer_ms:.1f} ms on the host clock = "
        f"{stats['tokens_per_s']:.1f} tokens/s, ground {ground_ms:.1f} ms "
        f"({len(spans)} spans), visual_cot_v1 {cot['v1']:.1f} ms, "
        f"visual_cot_v2 {cot['v2']:.1f} ms, peak {peak_gb:.2f} GB; plain "
        f"path first token {plain_first_ev['call']:.1f} ms, prefill "
        f"{plain_prefill_ms:.1f} ms, decode "
        f"{plain_decode_ms:.2f} ms a token, answer {plain_answer_ms:.1f} ms")
    del kernel, plain, params
    torch.cuda.empty_cache()
    return {"launches": total, "stats": stats}


def _trees_equal(got, want, where: str = "") -> None:
    """Same structure, dtypes, shapes and bits."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"files: keys differ at {where or '/'}")
        for k in want:
            _trees_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"files: lengths differ at {where}")
        for i, (a, b) in enumerate(zip(got, want)):
            _trees_equal(a, b, f"{where}/{i}")
    elif not (got.dtype == want.dtype and got.shape == want.shape
              and torch.equal(got, want.to(got.device))):
        raise AssertionError(f"files: leaf {where} differs from the tree it "
                             "was written from")


@contextlib.contextmanager
def _wrapped(module, name: str, wrapper):
    """``module.name`` replaced by ``wrapper(original)`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, wrapper(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _timed(run: dict, key: str):
    """A wrapper that adds the host seconds and the calls of a function to
    ``run[key]`` and ``run[key + '_n']``."""
    def wrap(fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            run[key] += time.perf_counter() - t0
            run[key + "_n"] += 1
            return out
        return timed
    return wrap


def _digest(obj, h) -> None:
    """Feed ``obj`` (arrays, containers, scalars, dataclasses by repr) into
    the hash ``h``."""
    if isinstance(obj, np.ndarray):
        h.update(f"{obj.dtype}{obj.shape}".encode())
        h.update(np.ascontiguousarray(obj).data)
    elif isinstance(obj, dict):
        h.update(f"dict{len(obj)}".encode())
        for k in sorted(obj, key=repr):
            h.update(repr(k).encode())
            _digest(obj[k], h)
    elif isinstance(obj, (list, tuple)):
        h.update(f"{type(obj).__name__}{len(obj)}".encode())
        for x in obj:
            _digest(x, h)
    else:
        h.update(repr(obj).encode())


def _copied(batch: dict) -> dict:
    return {k: v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v)
            for k, v in batch.items()}


def replaying(builds: dict, run: dict):
    """A wrapper of a batch builder that keeps each batch it builds in
    ``builds`` under a digest of its inputs (the first pass pays the digest,
    a few ms a batch) and gives a copy of the kept batch for inputs seen
    before, counting those in ``run['replayed']``.
    A builder is a deterministic function of its samples and spec, so a
    later pass over the same samples (a ground-truth pass, the --int8-sam
    CLIs over phase 25's files, phase 22's plain pass) reads the first
    pass's batches instead of building them again."""
    def wrap(build):
        def replayed(*args, **kwargs):
            h = hashlib.sha256()
            _digest((args, kwargs), h)
            key = h.hexdigest()
            if key in builds:
                run["replayed"] += 1
                return _copied(builds[key])
            batch = build(*args, **kwargs)
            builds[key] = dict(batch)  # the loop pops from its own dict
            return batch
        return replayed
    return wrap


def run_cli(main, argv: list, replace=None, tokenizer_cls=None,
            builds: dict | None = None) -> dict:
    """One eval CLI's ``main`` in process with the word-level tokenizer, its
    output on stderr, every launch count at 0 just before and read just
    after.  Its forwards are recorded (batch, SAM logits, CUDA-event ms,
    host seconds) and timed against its reads, decodes, batch builds and
    model setup.  ``replace(batch)`` stands in for the forward; with
    ``builds``, the batch builds go through ``replaying(builds)``."""
    run = {"batches": [], "logits": [], "forward_ms": [], "forward_s": 0.0,
           "replayed": 0}
    for key in ("read", "decode", "build", "setup"):
        run[key] = 0.0
        run[key + "_n"] = 0

    def builder(build):
        timed = _timed(run, "build")(build)
        return timed if builds is None else replaying(builds, run)(timed)

    def recording(make):
        def factory(model, params, cfg, device):
            run.update(params=params, cfg=cfg)
            predict = replace or make(model, params, cfg, device)

            def forward(batch):
                t0 = time.perf_counter()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = predict(batch)
                end.record()
                torch.cuda.synchronize()
                run["forward_s"] += time.perf_counter() - t0
                run["forward_ms"].append(start.elapsed_time(end))
                run["batches"].append(batch)
                run["logits"].append(out)
                return out
            return forward
        return factory

    with contextlib.ExitStack() as stack:
        stack.enter_context(_wrapped(data_io, "read_bytes",
                                     _timed(run, "read")))
        stack.enter_context(_wrapped(image_io, "decode_image",
                                     _timed(run, "decode")))
        stack.enter_context(_wrapped(collate, "build_batch", builder))
        stack.enter_context(_wrapped(mgm_data, "build_mgm_batch", builder))
        stack.enter_context(_wrapped(eval_cli, "setup",
                                     _timed(run, "setup")))
        stack.enter_context(_wrapped(eval_cli, "make_predict", recording))
        stack.enter_context(contextlib.redirect_stdout(sys.stderr))
        for fn in WRAPPERS.values():
            fn.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run["results"] = main(argv,
                              tokenizer=(tokenizer_cls or WordTokenizer)())
        torch.cuda.synchronize()
        run["wall_s"] = time.perf_counter() - t0
    run["launches"] = {name: fn.launches for name, fn in WRAPPERS.items()}
    run["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    return run


def write_world(root: pathlib.Path, card: str) -> dict:
    """Phase 25's checkpoints under ``root``, from one seed on the card: the
    DeepSeek-VL-1.3B checkpoint at full width and depth in the
    deepseek-vl-1.3b-chat layout as two bf16 safetensors shards, a SAM ViT-L
    ``.pth`` in the official layout in f32 and a released F-LMM trained
    ``.pth``.  Returns the paths and the trees they hold."""
    cfg = deepseek_vl.deepseek_vl_1_3b()
    g = torch.Generator(device="cuda").manual_seed(FILES_SEED)
    params = grounding.init_params(cfg, g, "cuda")
    randomize_rel_pos(params, g)
    fro = params["frozen"]
    # the released checkpoint is bf16 throughout, the aligner too: its f32
    # tree holds bf16 values, so the load gives the same bits back
    for layer in fro["projector"]:
        for k in ("w", "b"):
            layer[k] = layer[k].to(torch.bfloat16).float()
    sam = fro.pop("sam_encoder")
    paths = {"checkpoint": root / "deepseek-vl-1.3b-chat",
             "sam": root / "sam_vit_l.pth", "trained": root / "flmm.pth"}
    t0 = time.perf_counter()
    sd = checkpoint_writers.deepseek_vl_state_dict(fro, torch.bfloat16)
    n_params = sum(t.numel() for t in sd.values())
    written = checkpoint_writers.write_shards(paths["checkpoint"], sd, 2)
    del sd
    sd = checkpoint_writers.sam_encoder_state_dict(sam, dtype=torch.float32)
    n_sam = sum(t.numel() for t in sd.values())
    # the official file also holds the prompt encoder and mask decoder, the
    # trainer's start for them (phase 33)
    sd.update(checkpoint_writers.prompt_encoder_state_dict(
        params["trainable"]["sam"]["prompt"]))
    sd.update(checkpoint_writers.mask_decoder_state_dict(
        params["trainable"]["sam"]["decoder"]))
    torch.save(sd, paths["sam"])
    del sd
    torch.save({"state_dict": checkpoint_writers.released_trained_state_dict(
        params["trainable"])}, paths["trained"])
    sizes = {k: sum(f.stat().st_size for f in
                    (p.iterdir() if p.is_dir() else [p]))
             for k, p in paths.items()}
    log(f"phase 25 files ({card}): wrote DeepSeek-VL-1.3B ({n_params / 1e9:.3f}"
        f" G parameters, 2 bf16 safetensors shards, {written / 1e9:.3f} GB), "
        f"SAM ViT-L ({n_sam / 1e9:.3f} G encoder parameters and the prompt "
        "encoder and mask decoder, f32 .pth, "
        f"{sizes['sam'] / 1e9:.3f} GB) and the trained heads "
        f"({sizes['trained'] / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"cfg": cfg, "paths": paths, "sizes": sizes,
            "frozen": {**fro, "sam_encoder": sam},
            "trainable": params["trainable"]}


def check_loads(world: dict, card: str) -> dict:
    """Load the checkpoints through ``get_loader`` and ``restore_trainable``
    onto the card: every leaf equals the tree it was written from."""
    cfg, paths = world["cfg"], world["paths"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frozen = registry.get_loader("deepseek_vl")(
        str(paths["checkpoint"]), cfg, str(paths["sam"]), device="cuda")
    torch.cuda.synchronize()
    frozen_s = time.perf_counter() - t0
    template = grounding.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    t0 = time.perf_counter()
    trainable = ckpt.restore_trainable(str(paths["trained"]), cfg,
                                       template["trainable"])
    torch.cuda.synchronize()
    trained_s = time.perf_counter() - t0
    _trees_equal(frozen, world["frozen"])
    _trees_equal(trainable, world["trainable"])
    nbytes = world["sizes"]["checkpoint"] + world["sizes"]["sam"]
    stats = {"load_s": frozen_s, "load_gb": nbytes / 1e9,
             "load_gb_per_s": nbytes / 1e9 / frozen_s,
             "trained_s": trained_s}
    log(f"phase 25 files ({card}): get_loader('deepseek_vl') read "
        f"{nbytes / 1e9:.3f} GB (the 2 shards and the SAM .pth) onto the card "
        f"in {frozen_s:.2f} s = {stats['load_gb_per_s']:.2f} GB/s; "
        f"restore_trainable read the released .pth in {trained_s:.3f} s; "
        "every leaf of both trees equals the written one bit for bit")
    del frozen, trainable, template
    torch.cuda.empty_cache()
    return stats


def check_decodes(manifest: dict, card: str) -> dict:
    """Every committed fixture image through ``open_image``: the sha256 of
    its pixels equals PIL's (the manifest); ms per image on the host."""
    times = {".jpg": [], ".png": []}
    for name, want in manifest["images"].items():
        path = str(FIXTURE / name)
        px = image_io.open_image(path)
        if (list(px.shape) != want["shape"] or
                hashlib.sha256(px.tobytes()).hexdigest() != want["sha256"]):
            raise AssertionError(f"files: {name} decodes to other pixels "
                                 "than PIL's")
        data = data_io.read_bytes(path)
        t0 = time.perf_counter()
        for _ in range(DECODE_REPEATS):
            image_io.decode_image(data, path)
        times[pathlib.Path(name).suffix].append(
            (time.perf_counter() - t0) * 1e3 / DECODE_REPEATS)
    stats = {"jpeg_ms": sum(times[".jpg"]) / len(times[".jpg"]),
             "png_ms": sum(times[".png"]) / len(times[".png"])}
    log(f"phase 25 files ({card}): {len(manifest['images'])} fixture images "
        f"decoded without PIL to PIL's pixels (sha256); on the host "
        f"{stats['jpeg_ms']:.2f} ms a JPEG ({len(times['.jpg'])} files, "
        f"427 x 640 to 640 x 480) and {stats['png_ms']:.2f} ms a panoptic "
        f"PNG, mean of {DECODE_REPEATS} decodes each")
    return stats


def check_cli(label: str, run: dict, want_n: dict, card: str,
              path: str = "deepseek_vl_1_3b", forward=grounding.forward,
              phase: int = 25) -> dict:
    """The launches (exact a forward, those of ``path``), the scores
    (finite, every mask), the kernel ``forward`` against the all-plain one
    on the same batches, and the times of one CLI run."""
    batches = len(run["batches"])
    per_forward = EXPECTED_LAUNCHES[path]
    want = {k: per_forward.get(k, 0) * batches for k in WRAPPERS}
    log(f"phase {phase} {label}: {json.dumps(run['results'])}; {batches} "
        f"forwards; launches {({k: n for k, n in run['launches'].items() if n})}")
    if run["launches"] != want:
        raise AssertionError(f"{label}: launches differ from {want}")
    for key, n in want_n.items():
        res = run["results"][key] if key else run["results"]
        if res["n"] != n or not all(math.isfinite(v) for v in res.values()):
            raise AssertionError(f"{label} {key}: {res}, not {n} finite "
                                 "scores")
    plain = registry.plain_config(run["cfg"])
    with torch.no_grad():
        for i, (batch, logits) in enumerate(zip(run["batches"],
                                                run["logits"])):
            want_l = forward(run["params"], plain, from_jax(
                batch, "cuda"))["sam_logits"]
            rel, corr = agreement(logits, want_l)
            log(f"phase {phase} {label} batch {i}: sam_logits kernel vs plain "
                f"forward max_rel_err {rel:.3e} corr {corr:.6f} (bound "
                f"{FORWARD_CORR['sam_logits']})")
            if corr < FORWARD_CORR["sam_logits"]:
                raise AssertionError(f"{label}: the logits disagree")
    eval_s = run["wall_s"] - run["setup"]
    host_s = eval_s - run["forward_s"]
    stats = {
        "samples": run["n_samples"],
        "samples_per_s": run["n_samples"] / eval_s,
        "setup_s": run["setup"], "eval_s": eval_s,
        "forward_ms": sum(run["forward_ms"]) / batches,
        "host_ms": host_s * 1e3 / batches,
        "decode_ms": run["decode"] * 1e3 / batches,
        "read_ms": run["read"] * 1e3 / batches,
        "build_ms": run["build"] * 1e3 / batches,
        "peak_gb": run["peak_gb"]}
    log(f"phase {phase} {label} ({card}): {run['n_samples']} samples in {batches} "
        f"batches of 8 in {eval_s:.2f} s after a model setup of "
        f"{run['setup']:.2f} s (the checkpoints' load onto the "
        f"card): {stats['samples_per_s']:.2f} samples/s; forward "
        f"{stats['forward_ms']:.1f} ms a batch (CUDA events); host "
        f"{stats['host_ms']:.1f} ms a batch, of it image decode "
        f"{stats['decode_ms']:.1f} ms ({run['decode_n']} images), file reads "
        f"{stats['read_ms']:.2f} ms and the batch builder "
        f"{stats['build_ms']:.1f} ms"
        + (f" ({run['replayed']} of {run['build_n'] + run['replayed']} "
           "batches replayed from an earlier pass over the same samples)"
           if run["replayed"] else "")
        + f"; peak {stats['peak_gb']:.2f} GB above what was allocated "
        "before")
    return stats


def run_eval_clis(phase: int, common: list, card: str, manifest: dict,
                  path: str = "deepseek_vl_1_3b", forward=grounding.forward,
                  tokenizer_cls=None, gt_pass: bool = True,
                  builds: dict | None = None) -> tuple:
    """``eval_refcoco`` (8 splits, ``--debug``) and ``eval_png`` in process
    over the fixture tree with the checkpoint flags ``common``, each run
    checked (``check_cli``) and, with ``gt_pass``, run once more with the
    ground truth as +-8 logits in place of the forward; ``(stats,
    launches)``, each CLI's results in its stats.  With ``builds`` every
    run's batch builds go through ``replaying(builds)``."""
    stats, total = {}, dict.fromkeys(WRAPPERS, 0)
    narratives = json.loads((FIXTURE / "png" / "annotations" /
                             "png_coco_val2017.json").read_text())
    # (main, argv, masks by result key, samples, the oracle's metric); a
    # RefCOCO sample is one expression with its mask
    clis = {
        "eval_refcoco": (eval_refcoco.main, common + [
            "--data-root", str(FIXTURE / "refcoco"), "--debug"],
            manifest["refcoco_expressions"],
            sum(manifest["refcoco_expressions"].values()), "cIoU"),
        "eval_png": (eval_png.main, common + [
            "--data-root", str(FIXTURE / "png"), "--debug"],
            {"": manifest["png_masks"]}, len(narratives), "AA")}
    for name, (main_fn, argv, want_n, n_samples, metric) in clis.items():
        run = run_cli(main_fn, argv, tokenizer_cls=tokenizer_cls,
                      builds=builds)
        run["n_samples"] = n_samples
        stats[name] = check_cli(name, run, want_n, card, path, forward,
                                phase)
        stats[name]["results"] = run["results"]
        for k in WRAPPERS:
            total[k] += run["launches"][k]
        del run
        torch.cuda.empty_cache()
        if not gt_pass:
            continue

        def gt_logits(batch):
            """The ground truth as +-8 logits."""
            gt = torch.from_numpy(batch["gt_sam"]).cuda()
            return torch.where(gt > 0.5, 8.0, -8.0)

        oracle = run_cli(main_fn, argv, replace=gt_logits,
                         tokenizer_cls=tokenizer_cls, builds=builds)
        scores = {k: v[metric] for k, v in oracle["results"].items()} \
            if metric == "cIoU" else {"": oracle["results"][metric]}
        log(f"phase {phase} {name} ground truth as logits through the "
            f"CLI's own chain: {metric} {scores} (bound "
            f"{FILES_GT_MIN[metric]})")
        if not min(scores.values()) > FILES_GT_MIN[metric]:
            raise AssertionError(f"{name}: the ground truth scores "
                                 f"{scores}")
        del oracle
        torch.cuda.empty_cache()
    return stats, total


def run_files(card: str, root: pathlib.Path) -> dict:
    """Phase 25: files in, scores out.  The checkpoints written under
    ``root`` and loaded back bit for bit, the fixture images decoded to
    PIL's pixels, then ``eval_refcoco`` (8 splits, ``--debug``) and
    ``eval_png`` at their defaults on the card through the kernels, against
    the all-plain forward on the same batches, and their own chain fed the
    ground truth.  The checkpoints' ``paths`` are returned for phase 33."""
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    stats = {"decode": check_decodes(manifest, card)}
    world = write_world(root, card)
    stats["load"] = check_loads(world, card)
    del world["frozen"], world["trainable"]
    torch.cuda.empty_cache()
    paths = world["paths"]
    common = ["--checkpoint", str(paths["checkpoint"]),
              "--sam-checkpoint", str(paths["sam"]),
              "--trained", str(paths["trained"])]
    builds = {}  # the ground-truth pass and phase 35's CLIs replay them
    cli_stats, total = run_eval_clis(25, common, card, manifest,
                                     builds=builds)
    stats.update(cli_stats)
    return {"launches": total, "stats": stats, "paths": paths,
            "builds": builds}


def stage_split(params: dict, cfg, batch: dict) -> dict:
    """Device ms of each stage of one hybrid forward (CUDA events between
    the stages, the module calls ``grounding.forward`` makes), the mean over
    the last ``HYBRID_STAGE_ITERS - 1`` of ``HYBRID_STAGE_ITERS`` forwards;
    ``forward`` is the span of all six."""
    fro = params["frozen"]
    runs = []
    with torch.no_grad():
        for _ in range(HYBRID_STAGE_ITERS):
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(len(STAGES) + 1)]
            marks[0].record()
            high = sam_tower.forward(fro["vision_high"], cfg.hybrid_high,
                                     batch["hires_pixel_values"])
            marks[1].record()
            feats = vit.forward(fro["vision"], cfg.vision,
                                batch["pixel_values"],
                                select_layer=cfg.vision_select_layer)
            marks[2].record()
            img = grounding._project_hybrid(
                high.reshape(high.shape[0], -1, high.shape[-1]), feats,
                fro["projector"]).to(cfg.dtype)
            marks[3].record()
            attn, hidden = grounding.decoder_capture(params, cfg, batch, img)
            marks[4].record()
            emb = sam_encoder.forward(fro["sam_encoder"], cfg.sam.encoder,
                                      batch["sam_pixel_values"])
            marks[5].record()
            grounding.heads_forward(params, cfg, attn, hidden, batch,
                                    img_emb=emb)
            marks[6].record()
            runs.append(marks)
            del high, feats, img, attn, hidden, emb
    return _stage_ms(runs, STAGES)


def _stage_ms(runs: list, names: tuple) -> dict:
    """Mean device ms between consecutive events of each run but the first
    (a warm-up), by stage name, and their whole span as ``forward``."""
    torch.cuda.synchronize()
    timed = runs[1:]
    ms = {name: sum(m[i].elapsed_time(m[i + 1]) for m in timed) / len(timed)
          for i, name in enumerate(names)}
    ms["forward"] = sum(m[0].elapsed_time(m[-1]) for m in timed) / len(timed)
    return ms


def run_hybrid_serving(g: torch.Generator, card: str) -> dict:
    """Phase 26, serving: the DeepSeek-VL-7B forward at full width and
    depth, eager and aligned, each beside its all-plain forward, with the
    stage split of both paths."""
    cfg = deepseek_vl.deepseek_vl_7b()
    params = grounding.init_params(cfg, g, "cuda")
    params["frozen"]["llm"].pop("lm_head")  # the forward never uses it
    e2e_bench.randomize_frozen(params, g)
    fro = params["frozen"]
    paths = {}
    for path, img_start, seq in (
            ("deepseek_vl_7b", cfg.img_start, SEQ),
            ("deepseek_vl_7b_aligned", HYBRID_ALIGNED_START,
             HYBRID_ALIGNED_SEQ)):
        cfg_p = deepseek_vl.deepseek_vl_7b(img_start=img_start)
        batches = [from_jax(synthetic_batch(
            cfg_p, batch_size=BS, seq_len=seq, max_masks=MASKS,
            text_tokens_per_mask=TEXT, seed=seed), "cuda")
            for seed in range(HYBRID_REQUESTS + 1)]
        Hc, Wc = unet.output_hw(cfg_p.unet, (cfg_p.clip_shape,) * 2)
        P = cfg_p.sam.prompt_size
        shapes = {"sam_logits": (BS, MASKS, P, P),
                  "coarse_logits": (BS, MASKS, Hc, Wc),
                  "iou_pred": (BS, MASKS), "boxes": (BS, MASKS, 4),
                  "hidden": (BS, seq, cfg_p.llm.hidden_size)}
        served = phase_serve(26, path, grounding.forward, params, cfg_p,
                             batches, shapes)

        def hybrid_pairs(cfg, plain, batch, path=path):
            high = [sam_tower.forward(fro["vision_high"], c.hybrid_high,
                                      batch["hires_pixel_values"])
                    for c in (cfg, plain)]
            if not torch.equal(*high):
                raise AssertionError(f"{path}: the SAM-B tower differs "
                                     "between the kernel and the plain "
                                     "config (both run its plain path)")
            log(f"phase 26 {path} sam_b_tower {tuple(high[0].shape)}: bit "
                "for bit equal on the kernel and the plain path")
            del high
            embeds = [grounding.image_embeddings(fro, c, batch)
                      for c in (cfg, plain)]
            attn = [grounding.decoder_capture(params, c, batch, e)[0]
                    for c, e in zip((cfg, plain), embeds)]
            return {"image_embeddings": tuple(embeds), "attn": tuple(attn),
                    "sam_embedding": tuple(sam_encoder.forward(
                        fro["sam_encoder"], c.sam.encoder,
                        batch["sam_pixel_values"]) for c in (cfg, plain))}

        phase_compare(26, path, grounding.forward, params, cfg_p, served,
                      hybrid_pairs)
        served["stages"] = {
            "kernel": stage_split(params, cfg_p, served["requests"][0]),
            "plain": stage_split(params, registry.plain_config(cfg_p),
                                 served["requests"][0])}
        for which, ms in served["stages"].items():
            log(f"phase 26 stages {path} {which} path ({card}): " + ", ".join(
                f"{k} {v:.2f} ms" for k, v in ms.items())
                + f" (CUDA events, bs {BS}, S={seq}, mean of "
                f"{HYBRID_STAGE_ITERS - 1} forwards after one)")
        log(f"phase 26 timing {path} ({card}): kernel path "
            f"{served['ms']:.1f} ms/forward, {BS * 1e3 / served['ms']:.2f} "
            f"img/s, peak {served['peak_gb']:.2f} GB; plain path "
            f"{served['plain_ms']:.1f} ms/forward, "
            f"{BS * 1e3 / served['plain_ms']:.2f} img/s, peak "
            f"{served['plain_peak_gb']:.2f} GB (bs {BS}, mean of "
            f"{len(served['requests'])} requests after one warm-up)")
        del served["requests"], served["outs"], batches
        paths[path] = served
    del params, fro
    torch.cuda.empty_cache()
    return paths


def _leaf_checksums(tree: dict) -> dict:
    """Per leaf, the int64 sum of its bit pattern, in chunks of 2^24 words
    (no int64 copy of a whole 7B leaf): one changed bit of a leaf changes
    its sum."""
    ints = {2: torch.int16, 4: torch.int32}
    leaves = list(train_loop.tree_leaves(tree))
    sums = torch.stack([sum(
        c.sum(dtype=torch.int64) for c in t.contiguous().view(
            ints[t.element_size()]).flatten().split(1 << 24))
        for _, t in leaves])
    return dict(zip((p for p, _ in leaves), sums.tolist()))


def run_hybrid_train(card: str) -> dict:
    """Phase 26, training: ``python -m flmm_tpu_torch.train --preset 7b
    --sam-size 448 --batch-size 8 --synthetic`` for 3 steps, in process:
    finite losses, the exact launches a step, s/step and peak memory, and
    the frozen tree's per-leaf checksums the same after the steps as
    before the first."""
    seen = {}

    def recording(make):
        def factory(loss_fn, opt):
            step = make(loss_fn, opt)

            def checked(state, frozen, batch):
                if "before" not in seen:
                    seen["before"] = _leaf_checksums(frozen)
                seen["frozen"] = frozen
                return step(state, frozen, batch)
            return checked
        return factory

    out = io.StringIO()
    argv = ["--family", "deepseek_vl", "--preset", "7b", "--synthetic",
            "--sam-size", str(TRAIN_SAM), "--batch-size", str(TRAIN_BS),
            "--steps", str(HYBRID_TRAIN_STEPS), "--log-interval", "1"]
    with tempfile.TemporaryDirectory() as work, \
            _wrapped(train_loop, "make_train_step", recording), \
            contextlib.redirect_stdout(out):
        for fn in WRAPPERS.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer_cli.main([*argv, "--work-dir", work])
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]
    log(f"phase 26 train deepseek_vl_7b: {' '.join(argv)}: "
        + "; ".join(f"step {r['step']} loss {r['loss']:.4f} "
                    f"{r['sec_per_step']:.3f} s/step" for r in rows))
    if len(rows) != HYBRID_TRAIN_STEPS or not all(
            math.isfinite(r["loss"]) for r in rows):
        raise AssertionError("7b trainer: a step is missing or its loss is "
                             "not finite")
    want = {k: n * HYBRID_TRAIN_STEPS for k, n in
            EXPECTED_LAUNCHES["deepseek_vl_7b_train_sam448"].items()}
    after = _leaf_checksums(seen.pop("frozen"))
    log(f"phase 26 train deepseek_vl_7b: launches {launches} (expected "
        f"{want}); frozen tree: {len(after)} leaves, per-leaf checksums "
        f"unchanged: {after == seen['before']}")
    if launches != want:
        raise AssertionError("7b trainer: kernel launch counts differ from "
                             "the main path")
    if after != seen["before"]:
        raise AssertionError("7b trainer: the steps changed the frozen tree")
    s_step = [r["sec_per_step"] for r in rows]
    log(f"phase 26 timing train deepseek_vl_7b SAM-{TRAIN_SAM} ({card}): "
        f"{s_step[-1]:.3f} s/step (the last step on the trainer's own timer; "
        f"all steps {[round(x, 3) for x in s_step]}), "
        f"{TRAIN_BS / s_step[-1]:.2f} img/s, "
        f"peak {peak_gb:.2f} GB, {wall:.1f} s for the CLI in all (bs "
        f"{TRAIN_BS}, {HYBRID_TRAIN_STEPS} steps)")
    torch.cuda.empty_cache()
    return {"launches": launches, "s_per_step": s_step, "peak_gb": peak_gb}


def run_hybrid(card: str) -> dict:
    """Phase 26: DeepSeek-VL-7B served eagerly and aligned, its
    bench_torch.py row, and its trainer's steps."""
    paths = run_hybrid_serving(
        torch.Generator(device="cuda").manual_seed(HYBRID_SEED), card)
    knobs = e2e_bench.Knobs(preset="7b")
    row = e2e_bench.run(BS, E2E_ITERS, knobs, torch.device("cuda"))
    torch.cuda.empty_cache()
    check_e2e_row(26, row, "v8", preset="7b",
                  launches=EXPECTED_LAUNCHES["deepseek_vl_7b"])
    train = run_hybrid_train(card)
    return {"paths": paths, "row": row, "train": train, "launches": {
        name: row["launches"][name] * row["iters"]
        + train["launches"][name] for name in WRAPPERS}}


def run_mistral(card: str) -> dict:
    """Phase 27: LLaVA-NeXT over Mistral-7B, built by the bench.py twin at
    phase 6's bs 2: one kernel forward with its exact launches beside the
    all-plain forward, then its bench_torch.py row."""
    device = torch.device("cuda")
    path = "llava_next_mistral_7b"
    knobs = e2e_bench.Knobs(family="llava_next", preset="mistral_7b")
    model, cfg, params, batch = e2e_bench.build(ANYRES_BS, knobs, device)
    with torch.no_grad():
        for fn in WRAPPERS.values():
            fn.launches = 0
        out = model.forward(params, cfg, batch)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        want = EXPECTED_LAUNCHES[path]
        log(f"phase 27 {path}: bs {ANYRES_BS}, S="
            f"{batch['input_ids'].shape[1]}, image block at "
            f"{cfg.base.img_start}; launches {launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"{path}: kernel launch counts differ "
                                 "from the main path")
        ref = model.forward(params, registry.plain_config(cfg), batch)
        for key in ("hidden", "coarse_logits", "sam_logits"):
            rel, corr = agreement(out[key], ref[key])
            log(f"phase 27 {path} {key}: kernel vs plain forward "
                f"max_rel_err {rel:.3e} corr {corr:.6f} (bound "
                f"{FORWARD_CORR[key]})")
            if corr < FORWARD_CORR[key]:
                raise AssertionError(f"{path} {key}: kernel forward "
                                     "disagrees with the plain forward")
    del model, params, batch, out, ref
    torch.cuda.empty_cache()
    row = e2e_bench.run(ANYRES_BS, E2E_ITERS, knobs, device)
    torch.cuda.empty_cache()
    check_e2e_row(27, row, "v8", family="llava_next", preset="mistral_7b",
                  bs=ANYRES_BS, launches=want)
    return {"paths": {path: {"launches": launches}}, "row": row,
            "launches": {name: row["launches"][name] * row["iters"]
                         for name in WRAPPERS}}


# --- MGM (phases 28-32) -------------------------------------------------------

def randomize_aux(params: dict, g: torch.Generator) -> None:
    """ConvNeXt's layer scales at about ``MGM_GAMMA``, a trained tower's
    order (the init's 1e-6 makes every block the identity)."""
    for stage in params["frozen"]["aux_tower"]["stages"]:
        for bp in stage["blocks"]:
            bp["gamma"] = _randn(g, bp["gamma"].shape, 0.02, MGM_GAMMA)


def mgm_params(cfg, seed: int) -> dict:
    """An MGM model on the card from ``seed``: non-zero SAM rel-pos tables
    and ConvNeXt layer scales."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = mgm_model.init_params(cfg, g, "cuda")
    randomize_rel_pos(params, g)
    randomize_aux(params, g)
    return params


def mgm_batches(cfg, bs: int, seq: int, n: int = MGM_REQUESTS + 1) -> list:
    """The warm-up batch and ``n - 1`` distinct requests of an MGM phase:
    the samples of seeds 0 .. n - 1 through ``build_mgm_batch`` as the
    bench.py twin builds them, on the card."""
    return [from_jax(e2e_bench.samples_batch(cfg, "mgm", bs, seq,
                                             seed=seed), "cuda")
            for seed in range(n)]


def mgm_shapes(cfg, bs: int, seq: int) -> dict:
    Hc, Wc = registry.get_coarse_hw(cfg)
    P = cfg.base.sam.prompt_size
    return {"sam_logits": (bs, MASKS, P, P),
            "coarse_logits": (bs, MASKS, Hc, Wc), "iou_pred": (bs, MASKS),
            "boxes": (bs, MASKS, 4),
            "hidden": (bs, seq, cfg.base.llm.hidden_size)}


def mgm_pairs(params: dict):
    """What phase_compare holds between the kernel and the plain config
    beyond the outputs: the image embeddings (the CLIP features plus the
    mined aux tokens through the projector; ConvNeXt and the resampler run
    plain on both), the stitched attention maps and the SAM embedding."""
    fro = params["frozen"]

    def pairs(cfg, plain, batch):
        aux = convnext.forward(fro["aux_tower"], cfg.aux,
                               batch["aux_pixel_values"])
        embeds = tuple(mgm_model.mine_and_project(
            fro, c, mgm_model.tower_features(fro, c, batch["pixel_values"]),
            aux) for c in (cfg, plain))
        del aux
        maps = tuple(mgm_model.assemble_attention(c, mgm_model.capture(
            params, c, batch, e)["attn"]) for c, e in zip((cfg, plain),
                                                          embeds))
        return {"image_embeddings": embeds, "attn": maps,
                "sam_embedding": tuple(sam_encoder.forward(
                    fro["sam_encoder"], c.base.sam.encoder,
                    batch["sam_pixel_values"]) for c in (cfg, plain))}
    return pairs


def mgm_stage_split(params: dict, cfg, batch: dict) -> dict:
    """Device ms of each stage of one MGM forward (CUDA events between the
    calls ``mgm.forward`` makes), as ``stage_split``."""
    fro = params["frozen"]
    runs = []
    with torch.no_grad():
        for _ in range(HYBRID_STAGE_ITERS):
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(len(MGM_STAGES) + 1)]
            marks[0].record()
            feats = mgm_model.tower_features(fro, cfg, batch["pixel_values"])
            marks[1].record()
            aux = convnext.forward(fro["aux_tower"], cfg.aux,
                                   batch["aux_pixel_values"])
            marks[2].record()
            img = mgm_model.mine_and_project(fro, cfg, feats, aux)
            marks[3].record()
            out = mgm_model.capture(params, cfg, batch, img)
            marks[4].record()
            emb = sam_encoder.forward(fro["sam_encoder"], cfg.base.sam.encoder,
                                      batch["sam_pixel_values"])
            marks[5].record()
            grounding.heads_forward(
                params, cfg.base, mgm_model.assemble_attention(
                    cfg, out["attn"]), out["hidden"], batch, img_emb=emb)
            marks[6].record()
            runs.append(marks)
            del feats, aux, img, out, emb
    return _stage_ms(runs, MGM_STAGES)


def run_mgm_path(phase: int, path: str, cfg, bs: int, seq: int,
                 card: str) -> dict:
    """One MGM serving path at full width: MGM_REQUESTS requests beside the
    all-plain forward, the stage split of both paths, times and peak
    memory."""
    params = mgm_params(cfg, MGM_SEED)
    params["frozen"]["llm"].pop("lm_head", None)  # the forward never uses it
    batches = mgm_batches(cfg, bs, seq)
    served = phase_serve(phase, path, mgm_model.forward, params, cfg,
                         batches, mgm_shapes(cfg, bs, seq))
    phase_compare(phase, path, mgm_model.forward, params, cfg, served,
                  mgm_pairs(params))
    served["stages"] = {
        "kernel": mgm_stage_split(params, cfg, served["requests"][0]),
        "plain": mgm_stage_split(params, registry.plain_config(cfg),
                                 served["requests"][0])}
    for which, ms in served["stages"].items():
        log(f"phase {phase} stages {path} {which} path ({card}): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
            + f" (CUDA events, bs {bs}, S={seq}, mean of "
            f"{HYBRID_STAGE_ITERS - 1} forwards after one)")
    log(f"phase {phase} timing {path} ({card}): kernel path "
        f"{served['ms']:.1f} ms/forward, {bs * 1e3 / served['ms']:.2f} "
        f"img/s, peak {served['peak_gb']:.2f} GB; plain path "
        f"{served['plain_ms']:.1f} ms/forward, "
        f"{bs * 1e3 / served['plain_ms']:.2f} img/s, peak "
        f"{served['plain_peak_gb']:.2f} GB (bs {bs}, mean of "
        f"{len(served['requests'])} requests after one warm-up, host clock)")
    del served["requests"], served["outs"], batches, params
    torch.cuda.empty_cache()
    return served


def mgm_mixtral_cut():
    """MGM-Mixtral-8x7B with its decoder cut to ``MGM_MOE_LAYERS`` of 32
    layers (93 GB in bf16 whole) and the U-Net's in_channels derived from
    the cut depth as the preset derives them."""
    cfg = mgm_configs.mgm_mixtral_8x7b()
    base = cfg.base
    llm = dataclasses.replace(base.llm, num_layers=MGM_MOE_LAYERS)
    return dataclasses.replace(cfg, base=dataclasses.replace(
        base, llm=llm, unet=dataclasses.replace(
            base.unet, in_channels=llm.num_layers * llm.num_heads)))


def run_mgm_moe(card: str) -> dict:
    """Phase 30: the MoE MLP at full width: one bs-4 forward of the cut
    MGM-Mixtral-8x7B with its exact launches beside the all-plain forward,
    both timed with CUDA events."""
    path = "mgm_mixtral_8x7b_4_layers"
    cfg = mgm_mixtral_cut()
    params = mgm_params(cfg, MGM_SEED)
    params["frozen"]["llm"].pop("lm_head")  # the forward never uses it
    warm, batch = mgm_batches(cfg, BS, MGM_SEQ, 2)
    plain = registry.plain_config(cfg)
    ms = {}
    with torch.no_grad():
        mgm_model.forward(params, cfg, warm)
        mgm_model.forward(params, plain, warm)
        for which, c in (("plain", plain), ("kernel", cfg)):
            for fn in WRAPPERS.values():
                fn.launches = 0
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.reset_peak_memory_stats()
            start.record()
            out = mgm_model.forward(params, c, batch)
            end.record()
            torch.cuda.synchronize()
            ms[which] = start.elapsed_time(end)
            ms[which + "_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if which == "plain":
                ref = out
        launches = {name: fn.launches for name, fn in WRAPPERS.items()}
        want = EXPECTED_LAUNCHES[path]
        log(f"phase 30 {path}: the decoder cut to {MGM_MOE_LAYERS} of 32 "
            "layers (the whole model is 93 GB in bf16), U-Net in_channels "
            f"{cfg.base.unet.in_channels}; 8 experts a layer computed "
            f"densely, the top 2 a token; bs {BS}, S={MGM_SEQ}; launches "
            f"{launches} (expected {want})")
        if launches != want:
            raise AssertionError(f"{path}: kernel launch counts differ "
                                 "from the main path")
        for key, shape in mgm_shapes(cfg, BS, MGM_SEQ).items():
            if tuple(out[key].shape) != shape or not torch.isfinite(
                    out[key]).all():
                raise AssertionError(f"{path} {key}: wrong shape or values")
        for key in ("hidden", "coarse_logits", "sam_logits"):
            rel, corr = agreement(out[key], ref[key])
            log(f"phase 30 {path} {key}: kernel vs plain forward max_rel_err "
                f"{rel:.3e} corr {corr:.6f} (bound {FORWARD_CORR[key]})")
            if corr < FORWARD_CORR[key]:
                raise AssertionError(f"{path} {key}: kernel forward "
                                     "disagrees with the plain forward")
    log(f"phase 30 timing {path} ({card}): kernel path {ms['kernel']:.1f} "
        f"ms/forward, peak {ms['kernel_peak_gb']:.2f} GB; plain path "
        f"{ms['plain']:.1f} ms/forward, peak {ms['plain_peak_gb']:.2f} GB "
        f"(bs {BS}, one forward each after one warm-up, CUDA events)")
    del params, warm, batch, out, ref
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms}


class GemmaWordTokenizer(WordTokenizer):
    """The word-level stand-in with Gemma's special ids: BOS 2,
    ``<start_of_turn>`` 106, ``<end_of_turn>`` 107 (the gemma template's
    stop word), each its own word wherever it stands."""

    BOS = 2
    SPECIAL = {"<start_of_turn>": 106, "<end_of_turn>": 107}

    def encode(self, text: str, add_special_tokens: bool = False) -> list:
        for word in self.SPECIAL:
            text = text.replace(word, f" {word} ")
        return super().encode(text, add_special_tokens)


def run_mgm_generation(card: str) -> dict:
    """Phase 31: the grounder API at MGM-Gemma-2B, its LM head the tied
    embedding: ``answer`` (32 new tokens), ``ground`` on one span and
    ``visual_cot_v1`` through ``make_grounder('mgm')``, each with exact
    launches, against the all-plain grounder on the same weights."""
    base_mem = torch.cuda.memory_allocated()
    cfg = mgm_configs.mgm_gemma_2b()
    params = mgm_params(cfg, MGM_GEN_SEED)
    tokenizer = GemmaWordTokenizer()
    kernel, plain = (generation.make_grounder(
        "mgm", c, params, tokenizer, max_new_tokens=MGM_GEN_MAX_NEW)
        for c in (cfg, registry.plain_config(cfg)))
    h, w = GEN_IMAGES[0]
    image = np.random.default_rng(MGM_GEN_SEED).integers(0, 256, (h, w, 3),
                                                          np.uint8)
    total = dict.fromkeys(WRAPPERS, 0)
    L, H = cfg.base.llm.num_layers, cfg.base.llm.num_heads
    n_img = cfg.base.num_img_tokens
    warm = kernel.answer(image, GEN_QUESTION, max_new_tokens=2)
    kernel.ground(warm, [(0, 1)])
    del warm
    torch.cuda.reset_peak_memory_stats()

    def check(call, launches):
        _check_launches(call, launches, total, MGM_GEN_LAUNCHES, 31)

    (out, gen, ev_ms), answer_ms, launches = _counted(
        lambda: _answer_traced(kernel, image))
    check("answer", launches)
    T = len(out["output_ids"])
    maps, hidden = out["attention_maps"], out["hidden_states"]
    if not (1 <= T <= MGM_GEN_MAX_NEW
            and tuple(maps.shape) == (L, H, T, n_img)
            and tuple(hidden.shape) == (T, cfg.base.llm.hidden_size)
            and torch.isfinite(maps).all() and torch.isfinite(hidden).all()
            and 0 <= int(out["output_ids"].min())
            and int(out["output_ids"].max()) < cfg.base.llm.vocab_size):
        raise AssertionError("mgm generation answer: wrong shapes or values")
    log(f"phase 31 generation answer: {T} tokens, "
        f"{out['output_text'][:60]!r}...; attention maps "
        f"{tuple(maps.shape)}, hidden {tuple(hidden.shape)}, finite; the "
        "logits from the tied embedding (no lm_head in the tree: "
        f"{'lm_head' not in params['frozen']['llm']})")
    (pout, pgen, plain_ev), plain_ms, _ = _counted(
        lambda: _answer_traced(plain, image))
    llm_p = params["frozen"]["llm"]
    _agree("prefill capture (L, H, S, n_img)", gen["prompt_attn"],
           pgen["prompt_attn"], FORWARD_CORR["attn"], phase=31)
    _agree("prompt hidden", gen["prompt_hidden"], pgen["prompt_hidden"],
           FORWARD_CORR["hidden"], phase=31)
    _agree("first-step logits (tied head)",
           llm_decoder.logits(llm_p, cfg.base.llm, gen["last_hidden"]),
           llm_decoder.logits(llm_p, cfg.base.llm, pgen["last_hidden"]),
           0.99, phase=31)
    span = [(0, max(1, T // 2))]
    (coarse, masks), ground_ms, launches = _counted(
        lambda: kernel.ground(out, span))
    check("ground", launches)
    if (masks.shape != (1, h, w) or masks.dtype != np.uint8
            or not torch.isfinite(coarse).all()
            or tuple(coarse.shape[-2:]) != registry.get_coarse_hw(cfg)):
        raise AssertionError("mgm generation ground: wrong masks or logits")
    _agree("ground SAM low-res logits (one answer's maps)",
           kernel.ground_logits(out, span)[1],
           plain.ground_logits(out, span)[1], FORWARD_CORR["sam_logits"],
           phase=31)
    (thought, bbox, final, mask), cot_ms, launches = _counted(
        lambda: kernel.visual_cot_v1(image, GEN_QUESTION))
    check("visual_cot_v1", launches)
    x0, y0, x1, y1 = bbox
    if not (isinstance(final, str) and 0 <= x0 < x1 <= w
            and 0 <= y0 < y1 <= h and mask.shape == (h, w)):
        raise AssertionError("mgm generation visual_cot_v1: bad result")
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    stats = {"answer_ms": answer_ms, "tokens_per_s": T * 1e3 / answer_ms,
             "generate_ms": ev_ms["generate"], "before_ms": ev_ms["before"],
             "ground_ms": ground_ms, "cot_v1_ms": cot_ms,
             "plain_answer_ms": plain_ms, "peak_gb": peak_gb}
    log(f"phase 31 generation timing ({card}): answer {answer_ms:.1f} ms on "
        f"the host clock for {T} tokens = {stats['tokens_per_s']:.1f} "
        f"tokens/s, of it image preparation on the host, tokenisation and "
        f"both towers {ev_ms['before']:.1f} ms and prefill + decode "
        f"{ev_ms['generate']:.1f} ms (CUDA events); ground {ground_ms:.1f} "
        f"ms, visual_cot_v1 {cot_ms:.1f} ms (box {bbox}), peak "
        f"{peak_gb:.2f} GB; plain path answer {plain_ms:.1f} ms "
        f"({len(pout['output_ids'])} tokens)")
    del kernel, plain, params, gen, pgen, out, pout
    torch.cuda.empty_cache()
    return {"launches": total, "stats": stats}


def run_mgm_files(card: str) -> dict:
    """Phase 32: MGM files in, scores out.  A full-width gemma_2b model
    from a seed written as MGM's three checkpoints (the main one with
    ``model.mm_projector.*`` and ``model.vlm_uni_*``, a CLIP-L HF tower
    directory, an open_clip ConvNeXt-L ``open_clip_pytorch_model.bin``),
    a SAM ViT-L ``.pth`` and released-layout heads, loaded back through
    ``get_loader('mgm')`` and ``restore_trainable`` bit for bit, then both
    eval CLIs at ``--family mgm --preset gemma_2b`` with phase 25's
    gates."""
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    cfg = mgm_configs.mgm_gemma_2b()
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        params = mgm_params(cfg, MGM_FILES_SEED)
        fro = params["frozen"]
        sam = fro.pop("sam_encoder")
        t0 = time.perf_counter()
        paths = checkpoint_writers.mgm_checkpoints(root, fro)
        paths["sam"] = root / "sam_vit_l.pth"
        torch.save(checkpoint_writers.sam_encoder_state_dict(
            sam, dtype=torch.float32), paths["sam"])
        paths["trained"] = root / "flmm_mgm.pth"
        torch.save({"state_dict": checkpoint_writers.
                    released_trained_state_dict(params["trainable"])},
                   paths["trained"])
        nbytes = sum(f.stat().st_size for p in paths.values()
                     for f in (p.iterdir() if p.is_dir() else [p]))
        log(f"phase 32 files ({card}): wrote MGM-Gemma-2B's main, CLIP-L and "
            f"ConvNeXt-L checkpoints, SAM ViT-L and the heads "
            f"({nbytes / 1e9:.3f} GB) in {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frozen = registry.get_loader("mgm")(
            str(paths["checkpoint"]), cfg, str(paths["sam"]),
            clip_checkpoint=str(paths["clip"]),
            aux_checkpoint=str(paths["aux"]), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        template = mgm_model.init_trainable(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        trainable = ckpt.restore_trainable(str(paths["trained"]), cfg,
                                           template)
        _trees_equal(frozen, {**fro, "sam_encoder": sam})
        _trees_equal(trainable, params["trainable"])
        stats["load"] = {"load_s": load_s, "load_gb_per_s":
                         nbytes / 1e9 / load_s}
        log(f"phase 32 files ({card}): get_loader('mgm') read the four "
            f"checkpoints onto the card in {load_s:.2f} s = "
            f"{stats['load']['load_gb_per_s']:.2f} GB/s; every leaf of the "
            "frozen and the trained tree equals the written one bit for bit")
        del params, fro, sam, frozen, trainable, template
        torch.cuda.empty_cache()
        common = ["--family", "mgm", "--preset", "gemma_2b",
                  "--checkpoint", str(paths["checkpoint"]),
                  "--clip-checkpoint", str(paths["clip"]),
                  "--aux-checkpoint", str(paths["aux"]),
                  "--sam-checkpoint", str(paths["sam"]),
                  "--trained", str(paths["trained"])]
        # no second run with the ground truth as logits: phase 25 checks
        # the CLIs' own chain that way, and the pass took about 45 s here
        cli_stats, total = run_eval_clis(
            32, common, card, manifest, path="mgm_gemma_2b",
            forward=mgm_model.forward, tokenizer_cls=GemmaWordTokenizer,
            gt_pass=False)
        stats.update(cli_stats)
    return {"launches": total, "stats": stats}


def run_mgm(card: str) -> dict:
    """Phases 28-32: the MGM family on the card, each phase's seconds
    logged."""
    def timed(phase: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {phase} done in {time.perf_counter() - t0:.1f} s")
        return out

    paths = {
        "mgm_gemma_2b": timed(
            "28", run_mgm_path, 28, "mgm_gemma_2b",
            mgm_configs.mgm_gemma_2b(), BS, MGM_SEQ, card),
        "mgm_vicuna_7b_hd": timed(
            "29", run_mgm_path, 29, "mgm_vicuna_7b_hd",
            mgm_configs.mgm_vicuna_7b_hd(img_start=MGM_HD_START), MGM_HD_BS,
            MGM_HD_SEQ, card)}
    moe = timed("30", run_mgm_moe, card)
    paths["mgm_mixtral_8x7b_4_layers"] = {"launches": moe["launches"]}
    gen = timed("31", run_mgm_generation, card)
    files = timed("32", run_mgm_files, card)
    return {"paths": paths, "moe": moe, "gen": gen, "files": files}


class LlamaWordTokenizer(WordTokenizer):
    """The word-level stand-in inside Vicuna's 32000-word vocabulary: BOS 1,
    ``</s>`` 2, any other word 1000 up."""

    BOS = 1
    SPECIAL = {"</s>": 2}
    VOCAB = 32000


def trainer_run(argv: list, tokenizer, work: pathlib.Path,
                config_wrapper=None, steps: int = TRAIN_REAL_STEPS) -> dict:
    """``python -m flmm_tpu_torch.train`` in process (``argv`` plus the work
    directory and ``steps`` steps, each logged), its output on
    stderr, every launch count at 0 just before and read just after.
    Recorded: its config and model, the trainable tree before the first
    step, the frozen tree (and its per-leaf checksums before the first
    step), the optimizer, the last batch and state, the log rows, peak
    memory.  ``config_wrapper(get_config)`` stands in for the registry's
    ``get_config``."""
    run = {}

    def recording_setup(setup):
        def wrapped(*args, **kwargs):
            out = setup(*args, **kwargs)
            run.update(cfg=out["cfg"], model=out["model"])
            return out
        return wrapped

    def recording_step(make):
        def factory(loss_fn, opt):
            step = make(loss_fn, opt)

            def recorded(state, frozen, batch):
                if "before" not in run:
                    run["before"] = _clone_tree(state["params"])
                    run["frozen_sums"] = _leaf_checksums(frozen)
                run.update(opt=opt, frozen=frozen, batch=batch)
                state, metrics = step(state, frozen, batch)
                run["state"] = state
                return state, metrics
            return recorded
        return factory

    out = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_wrapped(trainer_cli, "setup", recording_setup))
        stack.enter_context(_wrapped(train_loop, "make_train_step",
                                     recording_step))
        if config_wrapper is not None:
            stack.enter_context(_wrapped(registry, "get_config",
                                         config_wrapper))
        stack.enter_context(contextlib.redirect_stdout(out))
        for fn in WRAPPERS.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer_cli.main([*argv, "--work-dir", str(work), "--steps",
                          str(steps), "--log-interval", "1"],
                         tokenizer=tokenizer)
        run["wall_s"] = time.perf_counter() - t0
    sys.stderr.write(out.getvalue())
    run["launches"] = {name: fn.launches for name, fn in WRAPPERS.items()}
    run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    run["rows"] = [json.loads(line) for line in out.getvalue().splitlines()
                   if line.startswith("{")]
    return run


def check_trainer_run(path: str, run: dict, bs: int, work, card: str,
                      steps: int = TRAIN_REAL_STEPS,
                      per_epoch: int | None = None) -> dict:
    """Phase 33's gates on one trainer run of ``steps`` steps: every step
    logged with a finite loss, the exact launches a step, every trainable
    subtree changed, the frozen tree's per-leaf checksums unchanged and none
    of its leaves needing grad, the checkpoint the trainer wrote restored
    bit for bit; then s/step, img/s and data-wait ms a step over the steps
    after the warm-up inside an epoch, and apart from them each step that
    starts an epoch of ``per_epoch`` batches (its stream builds a new
    loader, nothing queued)."""
    rows = run["rows"]
    log(f"phase 33 train {path}: " + "; ".join(
        f"step {r['step']} loss {r['loss']:.4f} grad_norm "
        f"{r['grad_norm']:.4f} {r['sec_per_step']:.3f} s data wait "
        f"{r['data_wait_ms']:.1f} ms" for r in rows))
    if [r["step"] for r in rows] != list(range(1, steps + 1)) \
            or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"{path}: a step is missing or its loss is not "
                             "finite")
    want = {k: n * steps for k, n in EXPECTED_LAUNCHES[path].items()}
    log(f"phase 33 train {path}: launches {run['launches']} (expected "
        f"{want}, {steps} steps)")
    if run["launches"] != want:
        raise AssertionError(f"{path}: kernel launch counts differ from the "
                             "main path")
    after = _clone_tree(run["state"]["params"])
    for sub in SUBTREES:
        if all(torch.equal(t, run["before"][p]) for p, t in after.items()
               if p == sub or p.startswith(sub + "/")):
            raise AssertionError(f"{path}: trainable subtree {sub} did not "
                                 "change")
    if _leaf_checksums(run["frozen"]) != run["frozen_sums"] or any(
            t.requires_grad for _, t in train_loop.tree_leaves(run["frozen"])):
        raise AssertionError(f"{path}: the steps changed the frozen tree")
    restored_equal(run["state"], run["opt"], work)
    log(f"phase 33 train {path}: every trainable subtree {SUBTREES} changed, "
        f"the frozen tree's {len(run['frozen_sums'])} per-leaf checksums "
        f"unchanged, the trainer's step_{steps} checkpoint restored bit for "
        "bit")
    starts = [r for r in rows[1:]
              if per_epoch and (r["step"] - 1) % per_epoch == 0]
    timed = [r for r in rows[1:] if r not in starts]
    s_step = sum(r["sec_per_step"] for r in timed) / len(timed)
    wait_ms = sum(r["data_wait_ms"] for r in timed) / len(timed)
    stats = {"s_per_step": s_step, "img_per_s": bs / s_step,
             "data_wait_ms": wait_ms, "peak_gb": run["peak_gb"],
             "wall_s": run["wall_s"], "launches": run["launches"],
             "epoch_starts": [{k: r[k] for k in ("step", "sec_per_step",
                                                 "data_wait_ms")}
                              for r in starts]}
    log(f"phase 33 timing train {path} ({card}): {s_step:.3f} s/step, "
        f"{bs / s_step:.2f} img/s, data wait {wait_ms:.1f} ms a step (mean "
        f"of {len(timed)} steps after one warm-up"
        f"{', those that start an epoch apart' if per_epoch else ''}, the "
        f"trainer's own timer), peak {run['peak_gb']:.2f} GB, "
        f"{run['wall_s']:.1f} s for the CLI in all (bs {bs})" + "".join(
            f"; step {r['step']}, the first of epoch "
            f"{(r['step'] - 1) // per_epoch}: {r['sec_per_step']:.3f} s, "
            f"data wait {r['data_wait_ms']:.1f} ms" for r in starts))
    return stats


def run_train_real(card: str, paths: dict) -> dict:
    """Phase 33: the trainer on real files, runs (a) to (e)."""
    stats, total = {}, dict.fromkeys(WRAPPERS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        data = ["--data-root", str(make_train_root(
            tmp / "coco", png_repeat=TRAIN_REAL_PNG_REPEAT))]
        samples = joint_samples(TRAIN_REAL_PNG_REPEAT)
        deepseek = ["--family", "deepseek_vl", "--preset", "1_3b",
                    "--batch-size", "8", "--seq-len", "704",
                    "--checkpoint", str(paths["checkpoint"]),
                    "--sam-checkpoint", str(paths["sam"]), *data]
        # (a) from phase 25's checkpoints, under phases 8-10's switch
        path = "deepseek_vl_1_3b_train_real"
        torch.use_deterministic_algorithms(True)
        try:
            run = trainer_run(deepseek, WordTokenizer(), tmp / "a",
                              steps=TRAIN_REAL_A_STEPS)
            stats[path] = check_trainer_run(
                path, run, 8, tmp / "a", card, steps=TRAIN_REAL_A_STEPS,
                per_epoch=samples // 8)
            cfg = run["cfg"]
            ref = registry.get_loader("deepseek_vl")(
                str(paths["checkpoint"]), cfg, str(paths["sam"]),
                device="cuda")
            ref["llm"].pop("lm_head", None)
            _trees_equal(run["frozen"], ref)
            del ref
            sam = load_mod.sam_trainable(str(paths["sam"]), cfg.sam, "cuda")
            for p, t in train_loop.tree_leaves(sam):
                if not torch.equal(run["before"]["sam/" + p], t):
                    raise AssertionError(f"{path}: trainable sam/{p} did not "
                                         "start from the SAM checkpoint")
            log(f"phase 33 train {path}: the frozen tree is the loaders' bit "
                "for bit, the trainable SAM started from the checkpoint's "
                "prompt encoder and mask decoder")
            step_against_plain(33, path, run["model"].loss_fn, cfg,
                               run["state"]["params"], run["frozen"],
                               run["batch"])
        finally:
            torch.use_deterministic_algorithms(False)
        total = {k: total[k] + run["launches"][k] for k in WRAPPERS}
        del run
        torch.cuda.empty_cache()
        # (d): phase 11's switches, which the trainer CLI cannot set, on
        # through the registry's get_config
        for path, argv, tokenizer, bs, config_wrapper in (
                ("llava_next_vicuna_7b_train_real",
                 ["--family", "llava_next", "--preset", "vicuna_7b",
                  "--batch-size", "2", "--seq-len", "3200", "--max-masks",
                  str(WIDE_MASKS[0]), *data],
                 LlamaWordTokenizer(), 2, None),
                ("mgm_gemma_2b_train_real",
                 ["--family", "mgm", "--preset", "gemma_2b", "--batch-size",
                  "4", *data], GemmaWordTokenizer(), 4, None),
                ("hpt_air_1_5_train_synthetic",
                 ["--family", "hpt", "--preset", "air_1_5", "--synthetic",
                  "--batch-size", "4"], None, 4,
                 lambda get: lambda *a, **k: hpt_switches(get(*a, **k)))):
            run = trainer_run(argv, tokenizer, tmp / path, config_wrapper)
            stats[path] = check_trainer_run(
                path, run, bs, tmp / path, card,
                per_epoch=None if "--synthetic" in argv else samples // bs)
            total = {k: total[k] + run["launches"][k] for k in WRAPPERS}
            del run
            torch.cuda.empty_cache()
        # (e) run (a) with --profile: its trace names each kernel
        run = trainer_run([*deepseek, "--profile", str(TRAIN_REAL_PROFILE)],
                          WordTokenizer(), tmp / "e")
        want = {k: n * TRAIN_REAL_STEPS for k, n in EXPECTED_LAUNCHES[
            "deepseek_vl_1_3b_train_real"].items()}
        trace = (tmp / "e" / "trace" / "trace.json").read_text()
        found = {k: trace.count(k) for k in TRAIN_REAL_TRACE_KERNELS}
        log(f"phase 33 train --profile {TRAIN_REAL_PROFILE}: a "
            f"{len(trace) / 1e6:.1f} MB trace; kernel events by name {found}; "
            f"launches {run['launches']} (expected {want})")
        if run["launches"] != want or not all(found.values()):
            raise AssertionError("the --profile run's launches or trace "
                                 "miss a kernel of the path")
        total = {k: total[k] + run["launches"][k] for k in WRAPPERS}
        del run, trace
        torch.cuda.empty_cache()
    return {"launches": total, "stats": stats}


class ScriptedStdin(io.TextIOBase):
    """Stdin of ``grounded_conversation --interactive``: the next question
    after a ``user> `` prompt (end of input when none is left) and ``y`` to
    every ``Ground X?`` prompt; ``out`` is where the prompts are written."""

    def __init__(self, out: io.StringIO, questions):
        self.out, self.questions = out, list(questions)

    def readline(self, size=-1):
        if self.out.getvalue().endswith("user> "):
            return self.questions.pop(0) + "\n" if self.questions else ""
        return "y\n"


def _event_ms(fn) -> tuple:
    """``fn()`` once between two CUDA events: ``(result, ms)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _expect(label: str, launches: dict, want: dict, total: dict) -> None:
    """Phase 34's launch check: exactly ``want`` (0 where it names none)."""
    _check_launches(label, launches, total, {label: want}, 34, "interactive")


def _times(table: dict, n: int) -> dict:
    return {k: v * n for k, v in table.items()}


def _sum_launches(*tables) -> dict:
    out = dict.fromkeys(WRAPPERS, 0)
    for t in tables:
        for k, v in t.items():
            out[k] += v
    return out


def run_sam_tools(card: str, sam_params: dict, images: list,
                  total: dict, tmp: pathlib.Path) -> dict:
    """Phase 34 (a)-(c): ``SamPredictor``, ``AutomaticMaskGenerator`` and
    ``export_sam_decoder`` on SAM ViT-L from phase 25's file."""
    cfg = deepseek_vl.deepseek_vl_1_3b()
    sam_cfg, plain_cfg = cfg.sam, registry.plain_config(cfg).sam
    kernel = predictor.SamPredictor(sam_params, sam_cfg, "cuda")
    plain = predictor.SamPredictor(sam_params, plain_cfg, "cuda")
    stats = {"set_image_ms": [], "preprocess_ms": [], "predict_ms": []}
    for i, image in enumerate(images):
        h, w = image.shape[:2]
        _, _, launches = _counted(lambda: kernel.set_image(image))
        _expect(f"(a) set_image {h} x {w}", launches, _SAM_BS1, total)
        _, ms = _event_ms(lambda: kernel.set_image(image))
        t0 = time.perf_counter()
        sam_preprocess(image, sam_cfg.encoder.img_size)
        prep_ms = (time.perf_counter() - t0) * 1e3
        stats["set_image_ms"].append(ms)
        stats["preprocess_ms"].append(prep_ms)
        log(f"phase 34 interactive (a) set_image {h} x {w} ({card}): "
            f"{ms:.1f} ms (CUDA events), of which the host's resize and "
            f"normalisation alone take {prep_ms:.1f} ms")
        plain.set_image(image)
        _agree(f"(a) set_image {h} x {w} embedding", kernel.embed,
               plain.embed, FORWARD_CORR["sam_embedding"],
               "the kernel encoder vs the plain encoder", 34, "interactive")
        box = np.array([w * 0.2, h * 0.25, w * 0.7, h * 0.8])
        prompts = {"point": dict(point_coords=np.array([[w // 2, h // 2]]),
                                 point_labels=np.array([1])),
                   "box": dict(box=box, multimask_output=False)}
        low = None
        for name in ("point", "box", "box_mask"):
            kw = (dict(prompts["box"], mask_input=low[:1])
                  if name == "box_mask" else prompts[name])
            (masks, iou, low_k), ms, launches = _counted(
                lambda: kernel.predict(**kw))
            _expect(f"(a) predict {name}", launches, {}, total)
            stats["predict_ms"].append(ms)
            _, _, low_p = plain.predict(**kw)
            _agree(f"(a) predict {name} low-res logits", low_k, low_p,
                   FORWARD_CORR["sam_logits"],
                   "the kernel predictor vs the plain one", 34, "interactive")
            n = 1 if name != "point" else 3
            if (masks.shape != (n, h, w) or masks.dtype != bool
                    or iou.shape != (n,) or low_k.shape != (
                        n, sam_cfg.prompt_size, sam_cfg.prompt_size)
                    or not np.isfinite(low_k).all()):
                raise AssertionError(f"interactive predict {name}: wrong "
                                     "shapes or values")
            if name == "box":
                low = low_k
            log(f"phase 34 interactive (a) predict {name} on {h} x {w}: "
                f"masks {masks.shape}, {masks.reshape(n, -1).sum(1)} px, "
                f"iou {np.round(iou, 4)}, {ms:.2f} ms")

    # (b) the automatic mask generator over the first image
    image = images[0]
    h, w = image.shape[:2]
    gen = amg.AutomaticMaskGenerator(
        sam_params, sam_cfg, points_per_side=AMG_POINTS,
        pred_iou_thresh=-10.0, stability_score_thresh=0.0, device="cuda")
    (embed, input_size), _, launches = _counted(
        lambda: predictor.encode_image(sam_params, sam_cfg, image, "cuda"))
    _expect("(b) amg encode", launches, _SAM_BS1, total)
    pts = gen.grid_points(input_size)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (low, ious), decode_ms = _event_ms(lambda: gen.decode(embed, pts))
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    plain_embed, _ = predictor.encode_image(sam_params, plain_cfg, image,
                                            "cuda")
    plain_low, _ = gen.decode(plain_embed, pts)
    _agree(f"(b) amg decode logits {tuple(low.shape)}", low, plain_low,
           FORWARD_CORR["sam_logits"],
           "on the kernel embedding vs the plain one", 34, "interactive")
    del plain_low, plain_embed
    t0 = time.perf_counter()
    records = gen.postprocess(low.flatten(0, 1), ious.reshape(-1),
                              input_size, (h, w))
    pass_all_ms = (time.perf_counter() - t0) * 1e3
    for r in records:
        m = rle_to_mask(r["segmentation"])
        if not (m.shape == (h, w) and int(m.sum()) == r["area"] > 0
                and amg.mask_box(m).tolist() == r["bbox"]
                and amg.mask_to_rle(m) == r["segmentation"]):
            raise AssertionError("interactive amg: a record's mask is not "
                                 "at the image's size or its RLE does not "
                                 "decode to it")
    log(f"phase 34 interactive (b) amg pass-all thresholds on {h} x {w}: "
        f"{low.shape[0]} prompts, {len(records)} records after NMS, each "
        f"an ({h}, {w}) mask whose RLE decodes to its area and box; host "
        f"postprocess of {low.shape[0] * low.shape[1]} masks "
        f"{pass_all_ms:.1f} ms")
    del low, ious
    gen = amg.AutomaticMaskGenerator(sam_params, sam_cfg,
                                     points_per_side=AMG_POINTS,
                                     device="cuda")
    (embed, input_size), encode_ms = _event_ms(
        lambda: predictor.encode_image(sam_params, sam_cfg, image, "cuda"))
    (low, ious), decode_ms = _event_ms(lambda: gen.decode(embed, pts))
    t0 = time.perf_counter()
    records = gen.postprocess(low.flatten(0, 1), ious.reshape(-1),
                              input_size, (h, w))
    post_ms = (time.perf_counter() - t0) * 1e3
    stats["amg"] = {"encode_ms": encode_ms, "decode_ms": decode_ms,
                    "postprocess_ms": post_ms, "records": len(records),
                    "decode_peak_gb": peak_gb,
                    "pass_all_postprocess_ms": pass_all_ms}
    log(f"phase 34 interactive (b) amg at the default thresholds ({card}): "
        f"encode {encode_ms:.1f} ms, decode of {AMG_POINTS ** 2} prompts in "
        f"one call {decode_ms:.1f} ms (peak {peak_gb:.2f} GB above the "
        f"embedding), host postprocess {post_ms:.1f} ms, {len(records)} "
        "records")
    del low, ious

    # (c) the decoder exported at full width, loaded back, against eager
    dec_params = {k: sam_params[k] for k in ("prompt", "decoder")}
    path = tmp / "sam_decoder.pt2"
    t0 = time.perf_counter()
    export.export_sam_decoder(dec_params, sam_cfg, path,
                              max_text=EXPORT_MAX_TEXT)
    export_s = time.perf_counter() - t0
    program = export.load_fn(path)
    g = torch.Generator(device="cuda").manual_seed(INTERACTIVE_SEED)
    P, d = sam_cfg.prompt_size, sam_cfg.prompt.embed_dim
    tvalid = torch.zeros((1, EXPORT_MAX_TEXT), dtype=torch.bool,
                         device="cuda")
    tvalid[0, :5] = True
    args = (kernel.embed.float(),
            torch.tensor([[200.0, 150.0, 700.0, 600.0]], device="cuda"),
            torch.randn((1, P, P), generator=g, device="cuda"),
            torch.randn((1, EXPORT_MAX_TEXT, d), generator=g, device="cuda"),
            tvalid)
    with torch.no_grad():
        got = program(dec_params, *args)
        emb, box, pm, text, tv = args
        pp = dec_params["prompt"]
        want = sam_decoder.forward(
            dec_params["decoder"], sam_cfg.decoder, emb,
            sam_prompt.dense_pe(pp, sam_cfg.prompt),
            torch.cat([sam_prompt.embed_boxes(pp, sam_cfg.prompt, box),
                       text], dim=1),
            sam_prompt.embed_masks(pp, sam_cfg.prompt, pm[..., None]),
            sparse_valid=torch.cat([torch.ones((1, 2), dtype=torch.bool,
                                               device="cuda"), tv], dim=1))
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(got, want))
    size = path.stat().st_size
    log(f"phase 34 interactive (c) export_sam_decoder: {size / 1e6:.2f} MB "
        f"artifact, exported in {export_s:.1f} s; the loaded program vs the "
        f"eager decoder max |diff| / max |eager| {rel:.3e} (bound "
        f"{EXPORT_REL_ERR}); masks {tuple(got[0].shape)}, iou "
        f"{tuple(got[1].shape)}")
    if rel > EXPORT_REL_ERR or tuple(got[0].shape) != (1, 4, P, P):
        raise AssertionError("interactive export: the exported decoder "
                             "disagrees with the eager one")
    stats["export"] = {"bytes": size, "export_s": export_s, "rel_err": rel}
    return stats


def run_interactive(card: str, paths: dict) -> dict:
    """Phase 34: the interactive slice on phase 25's files: (a)-(c) the SAM
    tools, (d) grounded_conversation single shot and two interactive turns,
    (e) visual_cot_inference v1 / v2 / v3, (f) infer_png --synthetic at
    1_3b, each with its exact launch counts."""
    total = dict.fromkeys(WRAPPERS, 0)
    images = [image_io.open_image(str(FIXTURE / n))
              for n in INTERACTIVE_IMAGES]
    cfg = deepseek_vl.deepseek_vl_1_3b()
    sd = load_mod.load_state_dict(str(paths["sam"]))
    sam_params = {
        "encoder": sam_weights.encoder_params(sd, cfg.sam.encoder,
                                              device="cuda"),
        "prompt": sam_weights.prompt_encoder_params(sd, cfg.sam.prompt,
                                                    device="cuda"),
        "decoder": sam_weights.mask_decoder_params(sd, cfg.sam.decoder,
                                                   device="cuda")}
    del sd
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        stats = run_sam_tools(card, sam_params, images, total, tmp)
        del sam_params
        torch.cuda.empty_cache()
        common = ["--family", "deepseek_vl", "--preset", "1_3b",
                  "--checkpoint", str(paths["checkpoint"]),
                  "--sam-checkpoint", str(paths["sam"]),
                  "--trained", str(paths["trained"])]
        run = {"answer": 0.0, "answer_n": 0, "ground": 0.0, "ground_n": 0}
        for v in ("v1", "v2", "v3"):
            run[f"visual_cot_{v}"], run[f"visual_cot_{v}_n"] = 0.0, 0
        written = []

        def recording(write):
            def rec(path, array):
                write(path, array)
                written.append((pathlib.Path(path), array))
            return rec

        def cli(main, argv, questions=None, **kw):
            out = io.StringIO()
            with contextlib.ExitStack() as stack:
                for name in run:
                    if not name.endswith("_n"):
                        stack.enter_context(_wrapped(
                            generation.Grounder, name, _timed(run, name)))
                stack.enter_context(_wrapped(grounded_conversation,
                                             "write_png", recording))
                stack.enter_context(contextlib.redirect_stdout(out))
                if questions is not None:
                    stack.enter_context(_wrapped(
                        sys, "stdin", lambda _: ScriptedStdin(out,
                                                              questions)))
                for fn in WRAPPERS.values():
                    fn.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                main(argv, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            log_text = out.getvalue()
            print(log_text, file=sys.stderr)
            return log_text, wall, {n: fn.launches
                                    for n, fn in WRAPPERS.items()}

        # (d) grounded conversation: single shot, then two turns on stdin
        conv = [*common, "--image", str(FIXTURE / INTERACTIVE_IMAGES[0]),
                "--max-new-tokens", str(INTERACTIVE_MAX_NEW)]
        for mode, extra, questions in (
                ("single shot", ["--text", GEN_QUESTION], None),
                ("interactive", ["--interactive"], INTERACTIVE_QUESTIONS)):
            for k in ("answer", "ground"):
                run[k], run[k + "_n"] = 0.0, 0
            written.clear()
            text, wall, launches = cli(
                grounded_conversation.main,
                conv + extra + ["--out", str(tmp / "g.png")], questions,
                tokenizer=NounTokenizer())
            answers, grounds = text.count("Answer:"), text.count("saved ")
            _expect(f"(d) grounded_conversation {mode} ({answers} answers, "
                    f"{grounds} grounds)", launches, _sum_launches(
                        _times(_TOWER, answers), _times(_SAM_BS1, grounds)),
                    total)
            want_answers = 1 if questions is None else len(questions)
            if (answers != want_answers or run["answer_n"] != answers
                    or not 1 <= grounds == run["ground_n"] == len(written)):
                raise AssertionError(f"interactive grounded_conversation "
                                     f"{mode}: wrong number of turns")
            for path, array in written:
                back = image_io.decode_png(path.read_bytes())
                if not (back.shape == images[0].shape
                        and np.array_equal(back, array)):
                    raise AssertionError(f"interactive {path.name}: the PNG "
                                         "does not read back as written")
            key = "single" if questions is None else "interactive"
            stats[f"conversation_{key}"] = {
                "answers": answers, "grounds": grounds, "wall_s": wall,
                "answer_ms": run["answer"] * 1e3 / max(answers, 1),
                "ground_ms": run["ground"] * 1e3 / grounds}
            log(f"phase 34 interactive (d) grounded_conversation {mode} "
                f"({card}): {answers} answers of up to "
                f"{INTERACTIVE_MAX_NEW} tokens, {grounds} grounds, PNGs "
                f"{[p.name for p, _ in written]} read back equal; answer "
                f"{stats[f'conversation_{key}']['answer_ms']:.1f} ms, ground "
                f"{stats[f'conversation_{key}']['ground_ms']:.1f} ms (host "
                f"clock), {wall:.1f} s with the model load")

        # (e) Visual CoT over a 2-item VisCoT JSON
        bench = tmp / "bench"
        bench.mkdir()
        (bench / "viscot.json").write_text(json.dumps(COT_ITEMS))
        for v in ("v1", "v2", "v3"):
            out_dir = tmp / f"cot_{v}"
            key = f"visual_cot_{v}"
            run[key], run[key + "_n"] = 0.0, 0
            _, wall, launches = cli(
                visual_cot_inference.main,
                [*common, "--version", v, "--benchmark-dir", str(bench),
                 "--image-root", str(FIXTURE), "--out", str(out_dir),
                 "--max-new-tokens", str(INTERACTIVE_MAX_NEW)],
                tokenizer=WordTokenizer())
            per_item = _TOWER if v == "v3" else _COT
            _expect(f"(e) visual_cot {v} ({len(COT_ITEMS)} items)", launches,
                    _times(per_item, len(COT_ITEMS)), total)
            records = json.loads((out_dir / "viscot.json").read_text())
            if not (len(records) == len(COT_ITEMS) and all(
                    set(r) == {"question", "thought", "bbox", "answer", "gt",
                               "image"} and len(r["bbox"]) == 4
                    for r in records)):
                raise AssertionError(f"interactive visual_cot {v}: bad "
                                     "records")
            ms = run[key] * 1e3 / run[key + "_n"]
            stats[key] = {"ms_per_item": ms, "wall_s": wall}
            log(f"phase 34 interactive (e) visual_cot {v} ({card}): "
                f"{ms:.1f} ms an item (host clock), boxes "
                f"{[r['bbox'] for r in records]}, {wall:.1f} s with the "
                "model load")

        # (f) infer_png --synthetic at 1_3b: one bs-2 forward
        out_dir = tmp / "png_vis"
        _, wall, launches = cli(
            infer_png.main, ["--synthetic", "--preset", "1_3b", "--out",
                             str(out_dir)])
        _expect("(f) infer_png --synthetic 1_3b", launches,
                EXPECTED_LAUNCHES["deepseek_vl_1_3b"], total)
        pngs = sorted(out_dir.iterdir())
        P = cfg.sam.prompt_size
        if [p.name for p in pngs] != ["synthetic_0.png", "synthetic_1.png"] \
                or any(image_io.decode_png(p.read_bytes()).shape != (P, P, 3)
                       for p in pngs):
            raise AssertionError("interactive infer_png: wrong PNGs")
        stats["infer_png_s"] = wall
        log(f"phase 34 interactive (f) infer_png: {[p.name for p in pngs]} "
            f"({P} x {P}), {wall:.1f} s with the model init")
    return {"launches": total, "stats": stats}



class TinyWordTokenizer(WordTokenizer):
    """The word-level stand-in inside the tiny presets' 256-word
    vocabulary: BOS 250, the stop word 251, ``<image_placeholder>`` 252,
    every other word a CRC32 in 10..249."""

    BOS = 250
    SPECIAL = {"<｜end▁of▁sentence｜>": 251, "<image_placeholder>": 252}

    def encode(self, text: str, add_special_tokens: bool = False) -> list:
        ids = [self.BOS] if add_special_tokens else []
        text = text.replace("<image_placeholder>", " <image_placeholder> ")
        return ids + [self.SPECIAL.get(w, 10 + zlib.crc32(w.encode()) % 240)
                      for w in text.split()]


def _leaf_sha256(tree: dict, prefix=()) -> dict:
    """``dotted name -> {shape, dtype, sha256 of the bytes}`` of a tree of
    CPU tensors (bf16 through its bit pattern)."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        a = (tree.view(torch.int16) if tree.dtype == torch.bfloat16
             else tree).numpy()
        return {".".join(prefix): {
            "shape": list(tree.shape),
            "dtype": str(tree.dtype).replace("torch.", ""),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}}
    out = {}
    for k, v in items:
        out.update(_leaf_sha256(v, prefix + (k,)))
    return out


def quant_host_checks(card: str) -> dict:
    """Phase 35 (a): the committed Orbax state read with none of JAX,
    orbax, tensorstore, zstandard or PIL loaded, every leaf the sha256 the
    fixture script recorded; every image of another kind decoded to PIL's
    sha256; then eval_refcoco at the tiny preset on the card with
    ``--trained`` the Orbax directory."""
    from flmm_tpu_torch.convert import orbax

    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    state = FIXTURE / manifest["orbax"]["path"]

    def loaded():
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in HOST_FORBIDDEN)

    if loaded():
        raise AssertionError(f"orbax: {loaded()} loaded before the read")
    cfg = deepseek_vl.tiny()
    template = grounding.init_trainable(cfg, torch.Generator(), "cpu")
    t0 = time.perf_counter()
    raw = orbax.read_params(state, template)
    read_s = time.perf_counter() - t0
    if _leaf_sha256(raw) != manifest["orbax"]["leaves"]:
        raise AssertionError("orbax: the restored leaves differ from the "
                             "fixture's sha256s")
    if loaded():
        raise AssertionError(f"orbax: the read loaded {loaded()}")
    nbytes = sum(t.numel() * t.element_size() for _, t in
                 train_loop.tree_leaves(raw))
    log(f"phase 35 orbax ({card}): {state.relative_to(FIXTURE.parent.parent)}"
        f" read without {', '.join(HOST_FORBIDDEN)} in sys.modules: "
        f"{len(manifest['orbax']['leaves'])} leaves ({nbytes / 1e6:.2f} MB, "
        f"f32 and bf16) equal to the recorded sha256s, in {read_s:.3f} s on "
        "the host (zstd, CRC-32C, OCDBT, zarr)")
    times = []
    for name, want in manifest["kinds"].items():
        t0 = time.perf_counter()
        px = image_io.open_image(str(FIXTURE / name))
        times.append((time.perf_counter() - t0) * 1e3)
        if (list(px.shape) != want["shape"] or hashlib.sha256(
                px.tobytes()).hexdigest() != want["sha256"]):
            raise AssertionError(f"kinds: {name} ({want['kind']}) decodes "
                                 "to other pixels than PIL's")
    log(f"phase 35 kinds ({card}): {len(times)} files of other kinds "
        f"({', '.join(sorted({w['kind'].split(',')[0] for w in manifest['kinds'].values()}))}) "
        f"decoded to PIL's sha256s, {sum(times) / len(times):.2f} ms a file "
        "on the host")
    # eval_refcoco --trained <the Orbax state> at the tiny preset
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        g = torch.Generator(device="cuda").manual_seed(FILES_SEED)
        params = grounding.init_params(cfg, g, "cuda")
        fro = params["frozen"]
        for layer in fro["projector"]:
            for k in ("w", "b"):
                layer[k] = layer[k].to(torch.bfloat16).float()
        sam = fro.pop("sam_encoder")
        checkpoint_writers.write_shards(
            root / "tiny", checkpoint_writers.deepseek_vl_state_dict(
                fro, torch.bfloat16), 1)
        torch.save(checkpoint_writers.sam_encoder_state_dict(
            sam, dtype=torch.float32), root / "sam.pth")
        run = run_cli(eval_refcoco.main, [
            "--preset", "tiny", "--checkpoint", str(root / "tiny"),
            "--sam-checkpoint", str(root / "sam.pth"), "--trained",
            str(state), "--data-root", str(FIXTURE / "refcoco"), "--debug"],
            tokenizer_cls=TinyWordTokenizer)
    want_tree = ckpt.restore_trainable(state, cfg, grounding.init_trainable(
        cfg, torch.Generator(), "cpu"))
    _trees_equal(run["params"]["trainable"], _to_cuda(want_tree))
    res = run["results"]
    counts = manifest["refcoco_expressions"]
    if (set(res) != set(counts) or any(res[k]["n"] != n for k, n in
                                       counts.items())
            or not all(math.isfinite(v) for r in res.values()
                       for v in r.values())):
        raise AssertionError(f"eval_refcoco --trained <orbax>: {res}")
    log(f"phase 35 eval_refcoco --preset tiny --trained "
        f"{state.relative_to(FIXTURE.parent.parent)} ({card}): "
        f"{json.dumps(res)}; {len(run['batches'])} forwards on the card, the "
        "trainable tree the Orbax state's")
    return {"launches": run["launches"], "orbax_read_s": read_s}


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cuda(v) for v in tree)
    return tree.cuda()


def quant_products(card: str) -> dict:
    """Phase 35 (b): ``int8_matmul``'s product on the card
    (``torch._int_mm``) at the main path's shapes against the exact product
    on the CPU (f64, exact here: every partial sum is an integer far below
    2**53), and the whole ``int8_matmul`` against its plain twin on the
    card; ms of the int8 product and of the bf16 product of the same
    shape."""
    from flmm_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(35)
    rows = {}
    for label, M, K, N in INT8_SHAPES:
        x = torch.randn((M, K), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn((K, N), generator=g, device="cuda") / math.sqrt(K)
        w_q, w_s = quant.quantize_weight(w)
        x_q, _ = quant.quantize_activations(x)
        y = quant.int8_product(x_q, w_q)
        exact = quant.int8_product_plain(x_q.cpu(), w_q.cpu())
        if not torch.equal(y.cpu(), exact):
            raise AssertionError(f"int8 {label}: the card's int32 product "
                                 "differs from the exact one")
        got = quant.int8_matmul(x, w_q, w_s)
        twin = quant.int8_matmul_plain(x, w_q, w_s)
        gap = ((got.float() - twin.float()).abs()
               / torch.finfo(torch.bfloat16).eps
               / twin.float().abs().clamp_min(1e-30)).max().item()
        if not torch.equal(got, twin):
            log(f"phase 35 int8 {label}: int8_matmul differs from its plain "
                f"twin by at most {gap:.2f} ulp")
        w_b = w.to(torch.bfloat16)
        ms = cuda_ms(lambda: quant.int8_product(x_q, w_q))
        bf16_ms = cuda_ms(lambda: x @ w_b)
        rows[label] = {"M": M, "K": K, "N": N, "int8_ms": ms,
                       "bf16_ms": bf16_ms, "equal_to_twin": torch.equal(
                           got, twin)}
        log(f"phase 35 int8 {label} ({M} x {K} -> {N}, {card}): int32 product "
            f"equal to the exact one; int8_matmul "
            f"{'equal to' if torch.equal(got, twin) else 'within'} its plain "
            f"twin's output{'' if torch.equal(got, twin) else f' ({gap:.2f} ulp)'}; "
            f"torch._int_mm {ms:.3f} ms ({2 * M * K * N / ms / 1e9:.1f} "
            f"TOP/s), the bf16 product {bf16_ms:.3f} ms")
        del x, w, w_q, x_q, y, exact, got, twin, w_b
    torch.cuda.empty_cache()
    return rows


def _timed_forwards(model, params, cfg, batches, warmup: int = 1) -> dict:
    """Forwards under no_grad: the first ``warmup`` untimed, then CUDA-event
    ms a forward, peak GB above what was allocated before, the launches
    (counts at 0 just before the timed ones) and the last output."""
    with torch.no_grad():
        for b in batches[:warmup]:
            model.forward(params, cfg, b)
        for fn in WRAPPERS.values():
            fn.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for b in batches[warmup:]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = model.forward(params, cfg, b)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
    n = len(batches) - warmup
    return {"ms": sum(ms) / n, "peak_gb": (torch.cuda.max_memory_allocated()
                                           - base) / 1e9,
            "launches": {k: fn.launches for k, fn in WRAPPERS.items()},
            "n": n, "out": out}


def quant_sam_forward(card: str) -> dict:
    """Phase 35 (c): DeepSeek-VL-1.3B at the bench preset (SAM-1024, bs 4,
    bf16, seeded weights, rel-pos tables randomised), its forward with
    ``quantize_frozen_sam`` and without, in the same call: the mean |sigmoid
    difference| of the SAM logits under 0.02, the int8 side's exact
    launches a forward (K6 20, K2 4, K1 0, K10 0, SigLIP's K3 / K4 24 and
    none in the SAM encoder), ms a forward and peak GB both ways."""
    model, cfg, params, batch = e2e_bench.build(BS, e2e_bench.Knobs(),
                                                "cuda")
    batches = e2e_bench.distinct_batches(batch, 1 + INT8_ITERS)
    bf16 = _timed_forwards(model, params, cfg, batches)
    q_params = grounding.quantize_frozen_sam(params)
    int8 = _timed_forwards(model, q_params, cfg, batches)
    want = {k: EXPECTED_LAUNCHES["deepseek_vl_1_3b_int8_sam"][k] * INT8_ITERS
            for k in WRAPPERS}
    if int8["launches"] != want:
        raise AssertionError(f"int8 SAM: launches {int8['launches']}, not "
                             f"{want}")
    delta = (torch.sigmoid(int8["out"]["sam_logits"].float())
             - torch.sigmoid(bf16["out"]["sam_logits"].float())).abs()
    mean = delta.mean().item()
    for key in ("sam_logits", "coarse_logits", "iou_pred"):
        if not torch.isfinite(int8["out"][key]).all():
            raise AssertionError(f"int8 SAM: non-finite {key}")
    enc = params["frozen"]["sam_encoder"]["blocks"]
    q_enc = q_params["frozen"]["sam_encoder"]["blocks"]
    gb = sum(t.numel() * t.element_size() for bp in enc
             for _, t in train_loop.tree_leaves(bp)) / 1e9
    q_gb = sum(t.numel() * t.element_size() for bp in q_enc
               for _, t in train_loop.tree_leaves(bp)) / 1e9
    log(f"phase 35 int8 SAM DeepSeek-VL-1.3B SAM-1024 bs {BS} ({card}): "
        f"mean |sigmoid(sam_logits) int8 - bf16| {mean:.5f} (bound "
        f"{INT8_SIGMOID_MAX}), max {delta.max().item():.4f}; launches a "
        f"forward {({k: v // INT8_ITERS for k, v in int8['launches'].items() if v})}; "
        f"bf16 {bf16['ms']:.1f} ms a forward, peak {bf16['peak_gb']:.2f} GB; "
        f"int8 SAM {int8['ms']:.1f} ms a forward, peak {int8['peak_gb']:.2f} "
        f"GB (mean of {INT8_ITERS} forwards after a warm-up, CUDA events); "
        f"SAM blocks' weights {gb:.3f} GB bf16, {q_gb:.3f} GB int8")
    if not mean < INT8_SIGMOID_MAX:
        raise AssertionError(f"int8 SAM: mean sigmoid difference {mean}")
    del model, params, q_params, batch, batches, bf16["out"], int8["out"]
    torch.cuda.empty_cache()
    return {"launches": int8["launches"], "mean_sigmoid_delta": mean,
            "bf16_ms": bf16["ms"], "int8_ms": int8["ms"],
            "bf16_peak_gb": bf16["peak_gb"], "int8_peak_gb": int8["peak_gb"]}


def quant_bench_rows(card: str, e2e_row: dict | None = None,
                     hpt_int8_row: dict | None = None) -> dict:
    """Phase 35 (e): bench_torch.py's rows with BENCH_QUANT_LLM=1 beside
    the bf16 rows: DeepSeek-VL-1.3B int8 in process beside phase 16's bf16
    row; HPT-Air-1.5's bf16 row in process beside phase 20's int8_llm row
    (its child).  A row not given is made here, in process.  Each int8 row
    launches what its bf16 row does."""
    device = torch.device("cuda")
    rows = {}
    for key, knobs in (("deepseek_vl int8", e2e_bench.Knobs(quant_llm=True)),
                       ("deepseek_vl bf16", None if e2e_row else
                        e2e_bench.Knobs()),
                       ("hpt bf16", e2e_bench.Knobs(family="hpt")),
                       ("hpt int8", None if hpt_int8_row else
                        e2e_bench.Knobs(family="hpt", quant_llm=True))):
        if knobs is not None:
            rows[key] = e2e_bench.run(BS, E2E_ITERS, knobs, device)
            torch.cuda.empty_cache()
    pairs = (("deepseek_vl_1_3b", e2e_row or rows["deepseek_vl bf16"],
              rows["deepseek_vl int8"]),
             ("hpt_air_1_5", rows["hpt bf16"],
              hpt_int8_row or rows["hpt int8"]))
    for name, bf16, int8 in pairs:
        if int8["launches"] != bf16["launches"]:
            raise AssertionError(f"bench {name}: the int8 row launches "
                                 f"{int8['launches']}, the bf16 row "
                                 f"{bf16['launches']}")
        log(f"phase 35 bench_torch {name} bs {bf16['bs']} ({card}): bf16 "
            f"{bf16['ms_mean']} ms a forward, {bf16['value']} img/s, peak "
            f"{bf16['peak_gb']} GB; BENCH_QUANT_LLM=1 {int8['ms_mean']} ms a "
            f"forward, {int8['value']} img/s, peak {int8['peak_gb']} GB (bs "
            f"{int8['bs']}); plain paths {bf16['plain']['ms_mean']} / "
            f"{int8['plain']['ms_mean']} ms")
    log(f"phase 35 bench_torch rows {json.dumps(rows)}")
    return {"launches": {
        k: sum(r["launches"][k] * r["iters"] for r in rows.values())
        for k in WRAPPERS}, "rows": rows}


def run_quant(card: str, paths: dict, files: dict, e2e: dict | None = None,
              families: dict | None = None) -> dict:
    """Phase 35: the int8 slice and the two repairs.  (a) the Orbax
    reader and the image kinds on the host, eval_refcoco --trained <Orbax>
    at tiny on the card; (b) the int8 products; (c) the int8 SAM encoder
    in the DeepSeek-VL-1.3B forward; (d) eval_refcoco and eval_png
    --int8-sam on phase 25's checkpoints, their scores beside phase 25's
    bf16 ones; (e) the BENCH_QUANT_LLM=1 rows beside the bf16 ones (those
    of phases 16 and 20 when ``e2e`` and ``families`` are given, else made
    here).  Alone: ``phase_card()``, ``phase_build()``, ``files =
    run_files(card, root)``, ``run_quant(card, files["paths"], files)``."""
    t0 = time.perf_counter()
    host = quant_host_checks(card)
    products = quant_products(card)
    forward = quant_sam_forward(card)
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    common = ["--checkpoint", str(paths["checkpoint"]),
              "--sam-checkpoint", str(paths["sam"]),
              "--trained", str(paths["trained"]), "--int8-sam"]
    cli_stats, cli_launches = run_eval_clis(
        35, common, card, manifest, path="deepseek_vl_1_3b_int8_sam",
        gt_pass=False, builds=files.get("builds"))
    for name in ("eval_refcoco", "eval_png"):
        log(f"phase 35 {name} --int8-sam ({card}): "
            f"{json.dumps(cli_stats[name]['results'])}; bf16 (phase 25): "
            f"{json.dumps(files['stats'][name]['results'])}; "
            f"{cli_stats[name]['forward_ms']:.1f} ms a batch forward "
            f"(bf16 {files['stats'][name]['forward_ms']:.1f}), peak "
            f"{cli_stats[name]['peak_gb']:.2f} GB (bf16 "
            f"{files['stats'][name]['peak_gb']:.2f})")
    bench = quant_bench_rows(
        card, e2e and e2e["rows"]["v8"],
        families and families["rows"]["hpt_int8_llm"])
    log(f"phase 35 done in {time.perf_counter() - t0:.1f} s")
    launches = {k: host["launches"][k] + forward["launches"][k]
                + cli_launches[k] + bench["launches"][k] for k in WRAPPERS}
    return {"launches": launches, "products": products, "forward": forward,
            "clis": cli_stats, "bench": bench["rows"]}


def check_e2e_row(phase: int, row: dict, global_kernel: str,
                  family: str = "deepseek_vl", preset: str = "1_3b",
                  bs: int = BS, launches: dict | None = None) -> None:
    """One row of the bench.py twin: its keys, its settings and the exact
    launch counts per forward (``launches``, default the 1.3B path's at
    ``global_kernel``; run() itself refuses non-finite logits)."""
    log(f"phase {phase} bench_torch {json.dumps(row)}")
    what = f"bench {family} {preset} {global_kernel}"
    launches = launches or E2E_LAUNCHES[global_kernel]
    want = {name: launches.get(name, 0) for name in WRAPPERS}
    if row["launches"] != want:
        raise AssertionError(f"{what}: launches per forward differ from "
                             f"{want}")
    if (row["global_kernel"], row["bs"], row["sam_size"], row["iters"],
            row["family"], row["preset"]) != (
                global_kernel, bs, 1024, E2E_ITERS, family, preset):
        raise AssertionError(f"{what}: wrong settings in the row")
    for r in (row, row["plain"]):
        if not (math.isfinite(r["value"]) and r["value"] > 0
                and 0 < r["ms_min"] <= r["ms_mean"] <= r["ms_max"]):
            raise AssertionError(f"{what}: bad time in {r}")


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def _zero_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def run_sharded_clis(card: str, files: dict, common: list) -> dict:
    """Phase 36 (a): eval_refcoco (its first split) and eval_png with
    --sharded-eval in process, a group of one on nccl; the results equal
    phase 25's host path for the same split, the launches those of its
    forwards."""
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    narratives = json.loads((FIXTURE / "png" / "annotations" /
                             "png_coco_val2017.json").read_text())
    name, _, split = eval_refcoco.SPLITS[0]
    key = f"{name}/{split}"
    runs = {
        "eval_refcoco": (eval_refcoco.main, "refcoco", key,
                         manifest["refcoco_expressions"][key]),
        "eval_png": (eval_png.main, "png", None, len(narratives))}
    total, stats = dict.fromkeys(WRAPPERS, 0), {}
    per_forward = EXPECTED_LAUNCHES["deepseek_vl_1_3b"]
    for label, (main_fn, root, res_key, n_samples) in runs.items():
        argv = common + ["--data-root", str(FIXTURE / root), "--debug",
                         "--sharded-eval"]
        replays = {"replayed": 0}
        with contextlib.ExitStack() as stack:
            stack.enter_context(_wrapped(eval_refcoco, "SPLITS",
                                         lambda splits: splits[:1]))
            if files.get("builds") is not None:  # phase 25's batches
                stack.enter_context(_wrapped(
                    collate, "build_batch",
                    replaying(files["builds"], replays)))
            stack.enter_context(contextlib.redirect_stdout(sys.stderr))
            _zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = main_fn(argv, tokenizer=WordTokenizer())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = _launch_counts()
        want = files["stats"][label]["results"]
        got, want = (got[res_key], want[res_key]) if res_key else (got, want)
        batches = -(-n_samples // 8)
        want_l = {k: per_forward.get(k, 0) * batches for k in WRAPPERS}
        log(f"phase 36 {label} --sharded-eval ({card}): {json.dumps(got)} "
            f"in {wall:.1f} s with the model setup; phase 25's host path "
            f"{json.dumps(want)}; launches "
            f"{({k: n for k, n in launches.items() if n})} ({batches} "
            f"forwards; {replays['replayed']} batches replayed from phase "
            "25's builds)")
        if got != want:
            raise AssertionError(f"{label}: --sharded-eval gives other "
                                 "results than the host path")
        if launches != want_l:
            raise AssertionError(f"{label}: launches differ from {want_l}")
        if torch.distributed.is_initialized():
            raise AssertionError(f"{label}: the CLI left its group open")
        stats[label] = {"wall_s": wall, "results": got}
        for k in WRAPPERS:
            total[k] += launches[k]
    return {"launches": total, "stats": stats}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_multihost_trainer(card: str) -> dict:
    """Phase 36 (b): the trainer with --multihost under a one-rank torchrun
    environment set in process (nccl, a store on localhost), against the
    same 3 steps without it: DeepSeek-VL-1.3B at SAM-448, bs 8, under the
    deterministic switch of phases 8-10; the logged metrics and the
    written state bit for bit."""
    argv = ["--family", "deepseek_vl", "--preset", "1_3b", "--synthetic",
            "--sam-size", str(TRAIN_SAM), "--batch-size", str(TRAIN_BS),
            "--steps", str(PAR_TRAIN_STEPS), "--log-interval", "1"]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for label, extra in (("one", []), ("multihost", ["--multihost"])):
                out = io.StringIO()
                saved = {k: os.environ.get(k) for k in env}
                if extra:
                    os.environ.update(env)
                try:
                    with contextlib.redirect_stdout(out):
                        _zero_launches()
                        t0 = time.perf_counter()
                        trainer_cli.main(argv + extra + [
                            "--work-dir", f"{tmp}/{label}"])
                        wall = time.perf_counter() - t0
                finally:
                    for k, v in saved.items():
                        if v is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = v
                sys.stderr.write(out.getvalue())
                rows = [json.loads(x) for x in out.getvalue().splitlines()
                        if x.startswith("{")]
                state = torch.load(pathlib.Path(tmp) / label /
                                   f"step_{PAR_TRAIN_STEPS}" / ckpt.STATE_FILE,
                                   map_location="cpu", weights_only=False)
                runs[label] = {"rows": rows, "state": state, "wall": wall,
                               "launches": _launch_counts()}
    finally:
        torch.use_deterministic_algorithms(False)
    one, mh = runs["one"], runs["multihost"]
    keys = [k for k in one["rows"][0] if k not in (
        "sec_per_step", "imgs_per_sec", "data_wait_ms", "wall")]
    log(f"phase 36 trainer --multihost ({card}): losses "
        f"{[r['loss'] for r in mh['rows']]} vs {[r['loss'] for r in one['rows']]}"
        f" without it; {mh['wall']:.1f} s vs {one['wall']:.1f} s for the CLI; "
        f"launches {({k: n for k, n in mh['launches'].items() if n})}")
    if [{k: r[k] for k in keys} for r in mh["rows"]] != \
            [{k: r[k] for k in keys} for r in one["rows"]] \
            or len(one["rows"]) != PAR_TRAIN_STEPS:
        raise AssertionError("--multihost: the logged metrics differ")
    leaves = list(zip(train_loop.tree_leaves(one["state"]),
                      train_loop.tree_leaves(mh["state"])))
    for (path, a), (_, b) in leaves:
        if not torch.equal(torch.as_tensor(a), torch.as_tensor(b)):
            raise AssertionError(f"--multihost: state leaf {path} differs")
    want = {k: n * PAR_TRAIN_STEPS for k, n in
            EXPECTED_LAUNCHES["deepseek_vl_1_3b_train_sam448"].items()}
    for label in runs:
        if runs[label]["launches"] != {k: want.get(k, 0) for k in WRAPPERS}:
            raise AssertionError(f"{label}: launches differ from {want}")
    log(f"phase 36 trainer --multihost: {len(leaves)} state leaves bit for "
        f"bit equal, {len(keys)} metrics of each step equal")
    return {"launches": mh["launches"]}


def _grounding_parts(params, cfg, batch) -> dict:
    """The forward in its stages: the capture, the hidden sum and the SAM
    logits; and next-token logits (of the final norm of the hidden sum's
    last 8 rows) through ``lm_head``."""
    emb = grounding.image_embeddings(params["frozen"], cfg, batch)
    attn, hidden = grounding.decoder_capture(params, cfg, batch, emb)
    out = grounding.heads_forward(params, cfg, attn, hidden, batch)
    llm = params["frozen"]["llm"]
    last = llm_decoder.rms_norm(hidden[:, -8:].to(cfg.dtype),
                                llm["final_norm"], cfg.llm.rms_eps, False)
    return {"attn": attn, "hidden": hidden, "sam_logits": out["sam_logits"],
            "lm_logits": llm_decoder.logits(llm, cfg.llm, last)}


def _decoder_inputs(params, cfg, batch) -> tuple:
    """``forward_capture``'s arguments as ``decoder_capture`` makes them."""
    fro, tra = params["frozen"], params["trainable"]
    emb = grounding.image_embeddings(fro, cfg, batch)
    ids = batch["input_ids"]
    embeds = llm_decoder.embed_tokens(fro["llm"], cfg.llm, ids).to(cfg.dtype)
    embeds[:, cfg.img_start:cfg.img_start + cfg.num_img_tokens] = emb
    kw = dict(merge_matrix=mask_ops.mean_merge_matrix(
        batch["mask_ids"], batch["mask_valid"].shape[1]), merge=cfg.merge,
        layer_weights=torch.softmax(tra["text_layer_weights"], dim=0))
    return (fro["llm"], cfg.llm, embeds, batch["attn_mask"], cfg.img_start,
            cfg.num_img_tokens), kw


def _decoder_parts(args: tuple, kw: dict, mesh=None) -> dict:
    """The decoder alone; through the pipeline over ``mesh`` (its stages'
    captures gathered) when given."""
    if mesh is None:
        out = llm_decoder.forward_capture(*args, **kw)
    else:
        out = pipe.pipeline_forward_capture(*args, mesh=mesh,
                                            n_microbatches=2, **kw)
        out["attn"] = pipe.gather_attn(out["attn"], mesh)
    return {k: out[k] for k in ("attn", "hidden", "last_hidden")}


def _parallel_rank(rank: int, world: int, store: str, results) -> None:
    """Phase 36 (c), one rank: a 1 x 2 mesh on nccl when the machine has a
    card a rank, else gloo with both ranks on cuda:0."""
    import torch.distributed as dist

    nccl = torch.cuda.device_count() >= world
    device = torch.device("cuda", rank if nccl else 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl" if nccl else "gloo",
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        results.put((rank, _parallel_checks(rank, device)))
    finally:
        dist.destroy_process_group()


def _parallel_checks(rank: int, device: torch.device) -> dict:
    cfg = deepseek_vl.deepseek_vl_1_3b()
    g = torch.Generator(device=device).manual_seed(PAR_SEED)
    params = grounding.init_params(cfg, g, device)
    randomize_rel_pos(params, g)
    batch = from_jax(synthetic_batch(
        cfg, batch_size=PAR_BS, seq_len=PAR_SEQ, max_masks=8,
        text_tokens_per_mask=12), device)
    mesh = mesh_lib.make_mesh(1, PAR_RANKS, device.type)
    seq = {"seq_axis": mesh_lib.axis_of(mesh, "model")}
    report = {"backend": torch.distributed.get_backend()}
    with torch.no_grad():
        ref = _grounding_parts(params, cfg, batch)
        dec_args, dec_kw = _decoder_inputs(params, cfg, batch)
        ref_dec = _decoder_parts(dec_args, dec_kw)
        # the sequence split where K5 runs: the image block at 128, S = 768
        cfg_a = deepseek_vl.deepseek_vl_1_3b(img_start=SP_ALIGNED_START)
        al_args, al_kw = _decoder_inputs(params, cfg_a, from_jax(
            synthetic_batch(cfg_a, batch_size=PAR_BS, seq_len=SP_ALIGNED_SEQ,
                            max_masks=8, text_tokens_per_mask=12), device))
        ref_al = _decoder_parts(al_args, al_kw)
        for mode in PAR_MODES:
            if mode == "pipeline":
                run = lambda: _decoder_parts(dec_args, dec_kw, mesh)  # noqa
                want = ref_dec
            elif mode == "sp":
                run = lambda: _decoder_parts(  # noqa
                    dec_args, {**dec_kw, **seq})
                want = ref_dec
            elif mode == "sp_aligned":
                run = lambda: _decoder_parts(al_args, {**al_kw, **seq})  # noqa
                want = ref_al
            else:
                sharded = {**params, "frozen": shard.shard_frozen(
                    params["frozen"], mesh, mode)}
                run = lambda: _grounding_parts(sharded, cfg, batch)  # noqa
                want = ref
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            _zero_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = run()  # timed and checked
            end.record()
            torch.cuda.synchronize()
            launches = _launch_counts()
            agree = {k: agreement(got[k], want[k]) for k in got}
            if mode == "fsdp":  # lm_head's columns: another GEMM shape
                for k in ("attn", "hidden", "sam_logits"):
                    if not torch.equal(got[k], want[k]):
                        raise AssertionError(f"rank {rank} fsdp {k}: not "
                                             "bit for bit the one-rank "
                                             "forward")
            for k, (_, corr) in agree.items():
                if corr < PAR_CORR[k]:
                    raise AssertionError(f"rank {rank} {mode} {k}: corr "
                                         f"{corr:.6f} < {PAR_CORR[k]}")
            want_l = {k: PAR_LAUNCHES[mode].get(k, 0) for k in WRAPPERS}
            if launches != want_l:
                raise AssertionError(f"rank {rank} {mode}: launches "
                                     f"{launches} != {want_l}")
            report[mode] = {
                "ms": start.elapsed_time(end), "peak_gb":
                torch.cuda.max_memory_allocated(device) / 1e9,
                "launches": launches, "agree": agree}
            del got, run
    return report


def run_parallel_ranks(card: str) -> dict:
    """Phase 36 (c): two ranks spawned on the card, each with its own
    checks (tp = 2 against the one-rank forward by correlation, fsdp = 2
    bit for bit, the 2-stage pipeline of 2 microbatches by correlation);
    a rank that fails fails the run.  Their launch counts come back."""
    import torch.multiprocessing as tmp_mp

    ctx = tmp_mp.get_context("spawn")
    results = ctx.SimpleQueue()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp_mp.start_processes(
            _parallel_rank, args=(PAR_RANKS, os.path.join(tmp, "store"),
                                  results),
            nprocs=PAR_RANKS, start_method="spawn")
    wall = time.perf_counter() - t0
    reports = dict(results.get() for _ in range(PAR_RANKS))
    total = dict.fromkeys(WRAPPERS, 0)
    for rank, rep in sorted(reports.items()):
        for mode in PAR_MODES:
            r = rep[mode]
            log(f"phase 36 rank {rank} {mode} ({card}, {rep['backend']}, "
                f"{PAR_RANKS} ranks sharing the card): {r['ms']:.1f} ms a "
                "forward (CUDA events, the mode's first forward, its "
                "kernels warmed by the one-rank reference), peak "
                f"{r['peak_gb']:.2f} GB, launches "
                f"{({k: n for k, n in r['launches'].items() if n})}; vs the "
                "one-rank forward " + ", ".join(
                    f"{k} max_rel_err {e:.3e} corr {c:.6f}"
                    for k, (e, c) in r["agree"].items()))
            for k in WRAPPERS:
                total[k] += r["launches"][k]
    log(f"phase 36 two ranks: {wall:.1f} s with the spawn and imports")
    return {"launches": total, "reports": reports}


def run_parallel(card: str, files: dict) -> dict:
    """Phase 36: the parallel slice, (a) to (c)."""
    paths = files["paths"]
    common = ["--checkpoint", str(paths["checkpoint"]),
              "--sam-checkpoint", str(paths["sam"]),
              "--trained", str(paths["trained"])]
    parts = [run_sharded_clis(card, files, common),
             run_multihost_trainer(card)]
    torch.cuda.empty_cache()
    parts.append(run_parallel_ranks(card))
    return {"launches": {k: sum(p["launches"][k] for p in parts)
                         for k in WRAPPERS},
            "parts": parts}


def run_measure_scripts(card: str) -> dict:
    """Phase 37: the three measurement scripts through their ``main``, the
    JSON lines they print logged as they come; their gates and launches."""
    _zero_launches()
    rows = fused_piece_bench.main([])
    fused = {"fused_ln_qkv": "ln_qkv_fused",
             "fused_proj_ln_mlp": "proj_ln_mlp_fused",
             "fused_ln_mlp": "ln_mlp_fused"}
    calls = kernel_bench.WARMUP + 10
    for name, op in fused.items():
        row = next(r for r in rows if r["op"] == op)
        if row["vs_plain"] > KERNEL_REL_ERR or row["launches"] != calls:
            raise AssertionError(f"fused_piece_bench {op}: {row}")
    launches = _launch_counts()
    want = {k: calls if k in fused else 0 for k in WRAPPERS}
    if launches != want:
        raise AssertionError(f"fused_piece_bench: launches {launches}")
    log(f"phase 37 fused_piece_bench ({card}): " + "; ".join(
        f"{r['op']} {r['ms']:.4f} ms" for r in rows))

    _zero_launches()
    t0 = time.perf_counter()
    ov = MEASURE_OVERLAP
    overlap = train_overlap_bench.main([
        "--preset", ov["preset"], "--batch-size", str(ov["batch_size"]),
        "--steps", str(ov["steps"]), "--workers", str(ov["workers"])])
    wall = time.perf_counter() - t0
    steps = 2 * (ov["steps"] + 1)  # (a) and (c), each after a warm step
    per_step = EXPECTED_LAUNCHES["deepseek_vl_1_3b_train_real"]
    want = {k: per_step[k] * steps for k in WRAPPERS}
    got = _launch_counts()
    if got != want:
        raise AssertionError(f"train_overlap_bench: launches {got} != "
                             f"{want}")
    if not all(math.isfinite(v) and v > 0 for k, v in overlap.items()
               if k.endswith("_s") and k != "data_wait_s") \
            or not 0 <= overlap["data_wait_s"] <= overlap["overlapped_step_s"]:
        raise AssertionError(f"train_overlap_bench: {overlap}")
    for k in WRAPPERS:
        launches[k] += got[k]
    log(f"phase 37 train_overlap_bench ({card}): device step "
        f"{overlap['device_step_s']:.4f} s, host batch "
        f"{overlap['host_batch_gen_s']:.4f} s, overlapped step "
        f"{overlap['overlapped_step_s']:.4f} s (data wait "
        f"{overlap['data_wait_s']:.4f} s of it), overlap factor "
        f"{overlap['overlap_factor']:.3f}; {wall:.1f} s with the set-up")

    # the proxy, one `python -m` process a SAM size, both at once: its tiny
    # steps are host-bound (~15k launches of PyTorch ops a step), so a fresh
    # interpreter a size runs them on cores of their own
    t0 = time.perf_counter()
    cmds = [[sys.executable, "-m", "flmm_tpu_torch.sam_size_accuracy_proxy",
             "--steps", str(MEASURE_PROXY_STEPS), "--tail",
             str(MEASURE_PROXY_TAIL), "--seeds", "1", "--sizes", str(frac)]
            for frac in MEASURE_PROXY_SIZES]
    with contextlib.ExitStack() as stack:
        procs = [stack.enter_context(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, text=True,
            cwd=pathlib.Path(__file__).resolve().parent)) for cmd in cmds]
        for p in procs:  # none outlives a failure (a no-op after exit)
            stack.callback(p.kill)
        outs = [p.communicate(timeout=MEASURE_PROXY_TIMEOUT)[0]
                for p in procs]
    wall = time.perf_counter() - t0
    curve = {}
    for cmd, p, out in zip(cmds, procs, outs):
        for line in out.splitlines():
            log(line)
        if p.returncode:
            raise AssertionError(f"{' '.join(cmd[1:])}: exit {p.returncode}")
        curve.update(json.loads(out.splitlines()[-1])["curve"])
    for frac, r in curve.items():
        m = r["mean"]
        if not (m["loss"] < m["head_loss"] and m["aiou"] > m["head_aiou"]):
            raise AssertionError(f"sam_size_accuracy_proxy at {frac}: the "
                                 f"heads did not learn: {m}")
        log(f"phase 37 sam_size_accuracy_proxy SAM {r['sam_size']} "
            f"({card}): loss {m['head_loss']} -> {m['loss']}, aiou "
            f"{m['head_aiou']} -> {m['aiou']}, sam_aiou {m['sam_aiou']} "
            f"(the first and the last {MEASURE_PROXY_TAIL} of "
            f"{MEASURE_PROXY_STEPS} steps)")
    log(f"phase 37 sam_size_accuracy_proxy: {wall:.1f} s for the "
        f"{len(cmds)} processes")
    return {"launches": launches, "fused": rows, "overlap": overlap,
            "proxy": curve}


def main() -> None:
    start = time.perf_counter()

    def stamp(what: str) -> None:
        log(f"elapsed {time.perf_counter() - start:.1f} s after {what}")

    card = phase_card()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    g_hpt = torch.Generator(device="cuda").manual_seed(1)
    g_bench = torch.Generator(device="cuda").manual_seed(2)
    g_e2e = torch.Generator(device="cuda").manual_seed(3)
    g_sweep = torch.Generator(device="cuda").manual_seed(4)
    g_eval = torch.Generator(device="cuda").manual_seed(5)
    kernels = phase_kernels(g, g_hpt, g_bench, g_e2e, g_sweep)
    stamp("phase 3")
    paths = {"deepseek_vl_1_3b": run_deepseek(g)}
    torch.cuda.empty_cache()
    paths["llava_next_vicuna_7b"] = run_llava_next(g)
    torch.cuda.empty_cache()
    paths["deepseek_vl_1_3b_train_sam448"] = run_train(g)
    torch.cuda.empty_cache()
    paths["hpt_air_1_5"] = run_hpt(g_hpt)
    torch.cuda.empty_cache()
    stamp("phases 4-12")
    bench = run_kernel_bench(g_bench)
    torch.cuda.empty_cache()
    stamp("phase 13")
    e2e = run_e2e_bench()
    stamp("phases 14-16")
    sweep = run_sweep(g_sweep)
    variants = run_window_variants(g_sweep)
    torch.cuda.empty_cache()
    stamp("phases 17-19")
    families = run_family_matrix()
    compared = compare_families()
    stamp("phases 20-21")
    evals = run_eval_phase(g_eval, card)
    stamp("phase 22")
    for family, row in families["rows"].items():
        log(f"phase 23 timing bench_families {family} {row['preset']} "
            f"({card}): kernel path {row['ms_mean']} ms/forward, "
            f"{row['value']} img/s, peak {row['peak_gb']} GB; plain path "
            f"{row['plain']['ms_mean']} ms/forward, {row['plain']['value']} "
            f"img/s, peak {row['plain']['peak_gb']} GB (bs {row['bs']}, "
            f"{row['iters']} forwards after {e2e_bench.WARMUP} warm-ups, "
            f"global_kernel={row['global_kernel']})")
    st = evals["stats"]
    log(f"phase 23 timing eval deepseek_vl_1_3b SAM-1024 ({card}): "
        f"{st['forward_ms']:.1f} ms a batch forward, {st['host_ms']:.1f} ms "
        f"a batch on the host, {st['samples_per_s']:.2f} samples/s, peak "
        f"{st['peak_gb']:.2f} GB, device busy {st['busy_share']:.1%} of the "
        f"loop (bs {EVAL_BS}, {EVAL_N} samples)")
    for path, r in paths.items():
        unit = r.get("unit", "forward")
        what = (f"{r['n']} steps" if unit == "step"
                else f"{len(r['requests'])} requests")
        log(f"phase 23 timing {path} ({card}): kernel path {r['ms']:.1f} "
            f"ms/{unit}, {r['bs'] * 1e3 / r['ms']:.2f} img/s, peak "
            f"{r['peak_gb']:.2f} GB; plain path {r['plain_ms']:.1f} "
            f"ms/{unit}, {r['bs'] * 1e3 / r['plain_ms']:.2f} img/s, peak "
            f"{r['plain_peak_gb']:.2f} GB (bs {r['bs']}, mean of {what} "
            "after one warm-up)")
    gen = run_generation(card)
    stamp("phase 24")
    # phase 25's checkpoints stay on disk for phase 33
    world_dir = tempfile.TemporaryDirectory()
    files = run_files(card, pathlib.Path(world_dir.name))
    stamp("phase 25")
    st = files["stats"]
    log(f"phase 25 timing files ({card}): load "
        f"{st['load']['load_gb_per_s']:.2f} GB/s, decode "
        f"{st['decode']['jpeg_ms']:.2f} ms a JPEG; eval_refcoco "
        f"{st['eval_refcoco']['samples_per_s']:.2f} samples/s, forward "
        f"{st['eval_refcoco']['forward_ms']:.1f} ms and host "
        f"{st['eval_refcoco']['host_ms']:.1f} ms a batch, peak "
        f"{st['eval_refcoco']['peak_gb']:.2f} GB; eval_png "
        f"{st['eval_png']['samples_per_s']:.2f} samples/s")
    hybrid = run_hybrid(card)
    paths.update(hybrid["paths"])
    torch.cuda.empty_cache()
    mistral = run_mistral(card)
    paths.update(mistral["paths"])
    torch.cuda.empty_cache()
    stamp("phases 26-27")
    mgm = run_mgm(card)
    paths.update(mgm["paths"])
    torch.cuda.empty_cache()
    stamp("phases 28-32")
    with world_dir:
        train_real = run_train_real(card, files["paths"])
        stamp("phase 33")
        inter = run_interactive(card, files["paths"])
        stamp("phase 34")
        quant = run_quant(card, files["paths"], files, e2e, families)
        stamp("phase 35")
        par = run_parallel(card, files)
        del files["builds"]
        stamp("phase 36")
    measure = run_measure_scripts(card)
    stamp("phase 37")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": sum(r["launches"][name] for r in (
             *paths.values(), bench, e2e, sweep, variants, families,
             compared, evals, gen, files, hybrid, mistral, mgm["gen"],
             mgm["files"], train_real, inter, quant, par, measure)),
         "launches_by_path": {
             **{p: r["launches"][name] for p, r in paths.items()},
             "kernel_bench": bench["launches"][name],
             "bench_torch": e2e["launches"][name],
             "schedule_bench": sweep["launches"][name],
             "window_variant_encoder": variants["launches"][name],
             "bench_families": families["launches"][name],
             "family_forwards": compared["launches"][name],
             "eval": evals["launches"][name],
             "generation": gen["launches"][name],
             "files": files["launches"][name],
             "deepseek_vl_7b_bench_train": hybrid["launches"][name],
             "llava_next_mistral_7b_bench": mistral["launches"][name],
             "mgm_generation": mgm["gen"]["launches"][name],
             "mgm_files": mgm["files"]["launches"][name],
             "train_real": train_real["launches"][name],
             "interactive": inter["launches"][name],
             "int8": quant["launches"][name],
             "parallel": par["launches"][name],
             "measure_scripts": measure["launches"][name]},
         **kernels[name]} for name in WRAPPERS]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
