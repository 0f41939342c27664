#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and none is caught. Each
prints its wall seconds. A pool of `POOL_WORKERS` worker processes,
spawned with the run before any CUDA work and joined before it exits,
makes what the card does not: phase 4's numpy oracles and the k-NN
corpora's NSW graphs and host oracles beside phases 1-5, then the CPU's
halves of the card-against-CPU checks (`HostPool`): each config's
phase-9 forward once its prefill is checked (`host_forward`), and phase
14's losses and gradients two ahead of their checks (`GradJobs`), on
half the host's cores (`pool_threads`), so that the main process's
host-bound decode keeps the other half. A worker draws its weights on the card with
a CUDA generator (`draw_weights`), as the main process draws the card's
copy, moves them to the CPU and saves its result to a file of the run's
temporary directory; the main process holds the card to it, the two
copies' weights equal (`weight_digest`). The host's cores and the
threads given are printed.

1. Card: print ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compile every CUDA source of the port (one ``nvcc`` each, all
   at once) and print the build seconds, then ptxas's registers, shared
   memory and spills of both SpMV kernels (``csr_spmv_merge``,
   ``csr_spmv_carries``), of the Hopper flash kernel
   (``flash_fwd_bf16_wgmma``, d 64, 80, 128 and 256, with and without the
   row log-sum-exp) and of its ``mma.sync`` kernels
   (``flash_fwd_bf16_mma``, d 16 and 32),
   of the flash backward's kernels (``flash_bwd_dq_bf16``,
   ``flash_bwd_dkdv_bf16`` at d 16 and 32; ``flash_bwd_dq_wgmma``,
   ``flash_bwd_dkdv_wgmma`` at d 64, 80, 128 and 256), of both bf16
   grouped-matmul kernels
   (``gmm_bf16_wgmma``, ``gmm_bf16_splitk``) and of its weight-gradient
   kernel (``gmm_bf16_tgmm``), with any line naming a kernel (ptxas's
   C75xx advisories that it serialised ``wgmma``). ``gmm_bf16_tgmm``'s
   two instantiations, ``flash_fwd_bf16_wgmma``'s eight (keyed by head
   dim and ``kLse``) and the four of each Hopper backward kernel,
   ``flash_bwd_dq_wgmma`` and ``flash_bwd_dkdv_wgmma`` (d 64, 80, 128 and
   256), must show no spill and no such advisory.
3. Kernel check: ``csr_spmv`` against its plain PyTorch version on the
   card (ragged rows, empty rows, a graph with no edges, a bucketed
   upload with sentinel edges of value 0; a 100k-edge hub across many
   blocks' shares; a larger bucketed upload with its full
   ``t_indptr``, whose sentinel row spans half the edges; the same upload's
   real rows only, so ``t_indptr[-1] < len(t_indices)``; rows of 512 edges
   and empty rows that end exactly on every chunk boundary and every
   block's share; one vertex; views of ``t_indptr``, ``t_indices`` and ``val``
   at 4-byte but not 16-byte offsets), rtol 1e-5 / atol 1e-6: float32
   sums taken in another order. Each result must also repeat bit for bit.
4. Serve: ``EngineSession(device="cuda")`` registers a 1M-vertex
   power-law community graph (the repo's ``lj-sim`` recipe, a stand-in
   for LiveJournal), lets the policy reorder it, and answers BFS, SSSP
   and BC (4 sources each), PR, CC and CC-SV. The launch counters are
   set to 0 just before and read just after; every answer is checked
   against the numpy oracles of ``core/baselines.py`` (exact for BFS,
   SSSP, CC and CC-SV; rtol 1e-4 for PR, 1e-3 for BC), made on the same
   graph in a worker process from the start of the run (`graph_oracles`).
   Then a warm launch of each through the backend, timed.
5. Kernel timing at the served graph's shapes (the real rows of its
   in-CSR, as PR's relaxation passes them): the kernel, its plain
   version, one ``torch.sparse`` CSR product as a yardstick (timed only;
   the port never calls it), the bound (bytes over 3.35 TB/s, the
   H100 SXM's HBM rate) and the wrapper's host ms a call.
4s. Sharded serve: the same graph through ``EngineSession(num_shards=4)``
   with a device budget of half its single-device bytes, so the policy
   places it sharded (4 shards on the card) and picks its hot prefix;
   BFS, SSSP and BC (phase 4's sources), PR, CC and CC-SV held to phase
   4's answers (bit for bit; PR rtol 1e-4, BC 1e-3), each request's
   exchange ledger and launch wall (its first launch partitions and
   uploads the kernel's edges), and a warm launch of each beside phase
   4's warm single-device launch. Then BFS, SSSP and
   CC through ``core/dist.py``'s runners with the hot prefix off and on,
   in the policy's order and in the original one: equal answers, the
   ledger, ``prefix_hit_rate`` and the wall of each, and 0 < savings < 1
   with the prefix on. Last, one k-NN batch of the integer corpus through
   a sharded session, ids equal to a single-device session's. No kernel
   of the port is on this path: the sharded PR gathers and sums in torch,
   as the reference's does in XLA.

k-NN search through ``EngineSession(device="cuda")``, the default
``SearchParams`` (beam 32, k_return 10, 96 steps):

* tests/test_search.py:164's corpus (240 x 8, NSW k 8): recall@10 of at
  least 0.95 against brute force;
* ``clustered_vectors(16_384, dim=128, num_clusters=64, seed=1)`` (SIFT1M's
  width with 16,384 of its 1,000,000 base vectors: the host NSW builder
  takes about 9 ms an insert), NSW k 16, 1,024 queries (corpus rows plus
  N(0, 0.01) jitter): at least 99% of the rows equal to the host beam
  search's (``core/baselines.knn_search_baseline``; float32 distances
  summed in another order may swap near-tied candidates) and recall@10
  within 0.01 of the host's; the same ids on a repeat and after
  ``refresh_hotness`` moves the graph to the visit-sorted layout and then
  patches it; the launch wall, the loop's iterations, the visited masks'
  bytes, the launch wall at 1, 64 and 1,024 queries;
* 2,048 integer-valued vectors of d 16 (exact float32 distances), NSW k
  8, 64 queries: every id equals the host oracle's and the summed visits
  equal the host's.

Then the LM slice, minicpm-2b at full width (``src/repro_torch/models``,
weights from ``init_params`` on the card, seed 7):

6. LM kernel checks: ``flash_attention`` against its plain version at the
   reference test's shapes (tests/test_kernels.py:61-103: (2,256,64),
   (1,512,128), (3,256,32), window 0 and 128) plus S = 300 and a
   causality case, float32 at rtol 1e-3 / atol 2e-3 and bf16 at 5e-2;
   grouped-query attention (k and v of 8 / group rows for 8 query rows,
   groups 2, 4 and 8) in every variant (bf16 at d 64, 128, 16, 32 and
   float32), window 0 and 128, S 256, 300 and 4,096, at the same
   tolerances and equal, bit for bit, to the same kernel on k and v
   repeated per query row; multi-head calls give the bits the kernel gave
   before it took grouped-query attention
   (tests/test_torch_cuda.py::MHA_DIGESTS); the causal, sliding-window,
   prefix-LM (prefix 256 and 700) and bidirectional masks in every
   variant, with head dims 80 and 256 in bf16, at S 300 and 1,000, and 8
   query rows on 1 kv row with a 256-token prefix at S 300 and 4,096;
   the Hopper kernel's row log-sum-exp at d 64, 80, 128 and 256 (8 query
   rows on 1 kv row, S 300, causal, prefix 40 and bidirectional): the
   output bits of the call without it, the plain version's log-sum-exp at
   rtol/atol 1e-4; the served configs' groups past 8 and mixtral's window
   (tests/test_torch_cuda.py::SERVED_FLASH_CASES, bf16 at d 128, one bf16
   unit of the output): 32 query rows over 2 kv rows (group 16) and 36
   over 4 (group 9) at S 300 and 4,096, window 0 and 128, and a window of
   4,096 at S 8,192 and 8,269 with groups 4, 9 and 16;
   ``hot_gather`` at the reference cases, at D 4,096 and 4,608, plus
   all-cold ids and H = vocab, exact. Each result must also repeat bit
   for bit.
7. Prefill: ``forward`` on the batch ``configs/shapes.input_specs``
   defines for ``prefill_32k`` (32,768 positions, its global batch of 32
   cut to 1 for one card) at all 40 layers; 40
   flash launches, all of them through the ``wgmma`` variant (bf16 at
   d = 64), 1 hot-slab launch, finite logits. The tokens come from
   the repo's own pipeline: a held-out batch of the Zipf-community corpus
   (``data/pipeline.py``, Zipf exponent 1.2, 64 topics), mapped through
   the vocab LOrder built from its first batch (``locality/vocab.py``).
   The flash kernel is held to its plain version on layer 0's q/k/v at
   the served shape (the first 2 of 36 heads at S = 32,768) and on all 36
   heads at S = 4,096 (with a sliding window, at twice the window, so
   that it cuts every row past it), bf16 at rtol 1.6e-2 / atol 1e-2 (two
   bf16 units at
   |o| >= 1); the hot-slab kernel to its plain version on the prefill's
   32,768 ids against the served slab, exact.
8. Consistency: a 64-token prompt through ``forward`` (flash kernel) and
   teacher-forced through ``decode_step`` (chunked attention over the
   cache), rtol/atol 0.15 and argmax agreement > 0.95
   (tests/test_models.py::test_decode_matches_forward); a position agrees
   where the top tokens are equal or tie to within one bf16 unit of the
   forward's top logit.
9. Card against CPU: the config cut to 2 layers (a hybrid keeps its
   shared block on the second, as ``configs/smoke_config`` cuts), the same
   weights on the CPU (plain versions, run in a pool worker) and the card
   (kernels), a 256-token prompt, the same standard.
10. Serve: ``serve_loop`` on 8 synthetic requests (seed 0), 4 slots,
    ``max_len`` 512, greedy, at full depth; the earlier configs of
    `SERVE_CUT` (all but chatglm3-6b, starcoder2-7b and mixtral-8x7b)
    on their first `SERVE_LAYERS` layers (`serve_view`: their weights),
    for the run's time limit; every request completes with
    ``max_new`` tokens and every decode step launches the hot-slab kernel
    once; the kernel is held to its plain version on every token the
    requests fed or sampled, 4 ids a call (the decode step's shape),
    exact. Then ``torch.profiler`` over 5 decode steps of the whole model
    at the served batch splits a step's wall into device time and the
    rest.
11. LM kernel timing at the served shapes, from CUDA events: each kernel,
    its plain version, one PyTorch call as a yardstick (timed only; the
    port never calls it) and the bound, from the (row, key) pairs the
    config's mask lets through (`ref.visible_pairs`: a window's and a
    prefix's counted). Flash also gets the bound of a float32-faithful PV
    (``faithful_bound_ms``: the split PV's ``6·d·pairs·BH`` FLOPs at the
    bf16 rate), which SDPA, rounding p to bf16, is not held to.

Then phases 7-11 on qwen2.5-3b at full width and depth (36 layers, d
2048, 16 heads of 128 over 2 kv heads, d_ff 11008, vocab 151,936, QKV
bias, tied embeddings: 3,085,844,480 parameters): 36 flash launches a
prefill, all ``wgmma`` with grouped kv (group 8), flash held to its plain
version on layer 0's real q and grouped k/v, timed beside
``F.scaled_dot_product_attention(..., enable_gqa=True)``.

Then phases 7-11 on paligemma-3b at full width and depth (18 layers, d
2048, 8 heads of 256 over 1 kv head, d_ff 16384, vocab 257,216, tied
embeddings: 2,508,660,736 parameters): a prefix of 256 embedding rows
(N(0, 1) from the seed) plus 32,512 tokens; 18 flash launches a prefill,
all ``wgmma`` (d 256, 64-key tiles), grouped (group 8) and
prefix-masked; decode against forward as a pure token stream
(``prefix_tokens`` 0, as tests/test_models.py runs it: a decode step
takes tokens only); card against CPU on 256 prefix rows plus 256 tokens;
flash timed beside ``F.scaled_dot_product_attention`` with an explicit
boolean (S, S) mask on the memory-efficient backend (k and v repeated per
head, which that backend needs), and beside
``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on
the backend it takes (``library_causal_ms``: causal only, without the
prefix's extra pairs, timed only). Then hubert-xlarge at full width
and depth (48 layers, d 1280, 16 heads of 80, bidirectional, d_ff 5120,
layernorm, a 504-way head: 945,131,520 parameters): the encoder forward
on 32,768 frames (N(0, 1) from the seed), 48 bidirectional flash
launches, all ``wgmma`` (d 80 in 128-column tiles); card against CPU on
256 frames; the flash timing beside ``is_causal=False`` SDPA. An encoder
has no decode step (``configs/shapes.cell_supported``), so phases 8 and
10 are skipped and say so. All library calls round p to bf16.

Then phases 7-11 on the two recurrent trunks at full width and depth,
weights from ``init_params`` on the card (seed 7):
rwkv6-3b (32 RWKV6 layers, d 2560, 40 wkv heads of 64, d_ff 8960, vocab
65,536, layernorm; 3,094,451,200 parameters, where the config's analytic
``param_count`` gives 2,642,575,360: both are printed) with no attention,
so 0 flash launches and 1 hot-slab launch a prefill and no flash check
(it says so); and zamba2-1.2b (38 Mamba2 layers, d 2048, d_inner 4096, 64
SSM heads of 64, state 64, chunk 64; a shared attention + gelu MLP block,
32 heads of 64, applied before the Mamba block at layers 5, 11, 17, 23,
29 and 35; vocab 32,000; 1,153,536,128 parameters), so 6 flash launches
a prefill, all ``wgmma``, causal, multi-head, held to the plain version
on the shared block's real q/k/v at its first application (the trunk run
through layers 0-4, then the block's norm1), and timed beside
``is_causal=True`` SDPA. Decode against forward on 64 tokens (both
chunked forms); card against CPU on 2 layers cut as ``smoke_config``
cuts (zamba2 keeps the shared block on its second); ``serve_loop`` with
one hot-slab launch a decode step. Then each trunk's scan on layer 0
(`time_scan`: the chunked wkv, the SSD; plain torch, its carried state
a Python loop of one launch a chunk): its device ms, busy ms, device ops
a call and the host launches a prefill.

Then phases 7-11 on chatglm3-6b at full width and depth (28 layers, d
4096, 32 heads of 128 over 2 kv heads, so a group of 16; half rotary,
q/k/v biases, d_ff 13696, vocab 65,024) and starcoder2-7b (32 layers, d
4608, 36 heads of 128 over 4, a group of 9; layernorm, biased tanh-GELU
MLP, output bias, d_ff 18432, vocab 49,152), each as qwen2.5-3b: one
grouped ``wgmma`` flash launch a layer a prefill, held to the plain
version on layer 0's real q and grouped k/v, timed beside
``F.scaled_dot_product_attention(..., enable_gqa=True)``.

Then the MoE slice, moonshot-v1-16b-a3b at full width (d 2048, 16 heads
of 128, 64 experts of d_ff 1408, top-6, 2 shared experts), its depth cut
to 16 of 48 layers so that the float32 masters (40.3 GB) and a
32,768-token prefill fit one 80 GB card; weights from ``init_params`` on
the card (seed 7), after the minicpm model is freed:

12. MoE kernel check: ``moe_gmm`` against its plain version on the card:
    the reference test's float32 cases (tests/test_kernels.py:106-138) at
    rtol/atol 1e-4, then bf16 at the smoke (64/128), served (2048/1408)
    and K 136 / N 200 widths and at mixtral-8x7b's (8 experts, 4096/14336
    and 14336/4096 at 1,000 rows, and a decode step's 8 rows;
    tests/test_torch_cuda.py::MIXTRAL_GMM_CASES) with empty groups, one
    group holding every row, rows past the groups' total (zero) and M not
    a multiple of 128,
    through both bf16 kernels (``wgmma`` and ``splitk``, each forced with
    ``variant=``). The float32 result of bf16 operands is held at
    rtol/atol 1e-4 (the products are exact in float32; only the order of
    the sums differs), the bf16 result must be it rounded once, and a
    repeat must give the same bits; the two kernels' bits may differ.
13. Phases 7-11 on moonshot: the prefill (16 flash launches through the
    ``wgmma`` variant at d = 128, 1 hot-slab and 48 ``moe_gmm`` launches,
    all through its ``wgmma`` kernel, a finite aux loss), with flash held
    to its plain version at d = 128 (2 heads at S = 32,768, all 16 at
    S = 4,096) and both ``moe_gmm`` kernels on layer 0's real
    expert-sorted rows through the gate and the down products (float32 at
    1e-4), layer 0's group sizes and ``locality/moe.dispatch_stats``; decode against forward and card
    against CPU at 2 layers, where the free-running run's routing must
    part from the other's at the first layer only at router margins below
    1e-3, and the logits are held to phase 8's standard on a run that
    replays the other's expert choices (``models.moe.RouteTape``), since
    a choice parted at a near-tie moves every later layer and position;
    ``serve_loop`` with 48 ``moe_gmm`` launches per decode step, all
    through its ``splitk`` kernel; the profile; the kernel timings; and
    ``moe_gmm`` timed at the prefill's gate and down products and at a
    decode step's 24 rows, both kernels, with ``torch._grouped_mm`` as the
    yardstick and, at the decode step, the wrapper's host ms a call; then
    a sweep of both kernels over 4 to 32,768 tokens of layer 0's routing,
    with the kernel the rule picks and a repeat's bits.
    Then the same on mixtral-8x7b at full width (d 4096, 32 heads of 128
    over 8 kv heads, a sliding window of 4,096, 8 experts of d_ff 14336,
    top 2), its depth cut to 8 of 32 layers (43.2 GiB of float32
    masters): 8 grouped, windowed ``wgmma`` flash launches a prefill (the
    flash check's all-heads case at S 8,192; the bound from the window's
    pairs; the yardstick a boolean (S, S) window mask on SDPA's
    memory-efficient backend, beside causal SDPA, timed only) and 24
    ``moe_gmm`` launches a prefill and a decode step, through the kernel
    the rule picks (one row an expert at a decode step is past split-K's
    half a row); no variant sweep. Then smoke mixtral (window 8)
    teacher-forced for `RING_STEPS` decode steps on the card against the
    CPU (`ring_decode_check`): its 8-slot ring wraps twice, which no
    full-width serve reaches.

Then training, after the MoE model is freed:

14. Training. The flash backward's Hopper kernels
    (``flash_bwd_dq_wgmma``, ``flash_bwd_dkdv_wgmma``) at a qwen2.5-3b
    microbatch's attention (32 query rows of 4,096 over 4 kv rows, d 128,
    causal), a minicpm-2b one's (72 rows, d 64), a paligemma-3b one's
    (16 rows over 2 kv rows, d 256, causal with its 256-row prefix),
    zamba2-1.2b's shared block's (64 rows, d 64), a chatglm3-6b one's (64
    rows over 4, group 16), a starcoder2-7b one's (72 over 8, group 9)
    and mixtral-8x7b's heads (64 over 16, group 4) with its 4,096-token
    window at S 8,192 + 77, where it cuts (`BWD_SHAPES`):
    FlashAttention's
    standard, each of dq, dk and dv at most 2x (plus 1e-3) the max error
    of the plain bf16 path against a float64 autograd oracle, a repeat's
    bits equal, and the plain version (``attention_bwd_ref``) at rtol 2e-2
    of the largest gradient; the same checks of the ``mma.sync`` pair
    (``flash_bwd_dq_bf16``, ``flash_bwd_dkdv_bf16``) at qwen2.5-3b's
    microbatch with d 32; each check's two calls launch both kernels of
    its variant and no other, counted under its kv group and, with a
    window, as windowed; the Hopper kernels timed at those shapes
    (`BWD_TIMING`: mixtral's at S 16,384, with its window and without,
    the windowed time held below 0.75 of the other's), each kernel alone
    and
    the pair, with each kernel's TFLOP/s of its own products, beside the
    plain version, the bound (five products at the bf16 rate, a prefix's
    extra pairs and a window's cut counted; also seven, what the two
    kernels issue, and the
    FLOPs of the 64 x 64 blocks they multiply whole) and the backward
    alone of
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    (timed only, on the backend it takes; causal only, so without a
    prefix's pairs and with those a window cuts; ``library_ms`` null with
    the refusals where no backend takes it). Then qwen2.5-3b at full width
    and depth (36 layers, 3,085,938,688 parameters, remat on) trained
    for `TRAIN_STEPS` steps through ``train.steps.make_train_step`` with
    ``TrainConfig(microbatch=2)`` (the reference's defaults otherwise): 8
    x 4,096 tokens a step (``train_4k``'s sequence, its batch of 256 cut
    to 8) from the Zipf corpus through the vocab LOrder
    (``data.pipeline.DataLoader``, ``VocabReorder.apply_to_params``),
    microbatches of 2; each step's
    loss, grad norm, seconds, tokens/s and peak memory; 36 x 4 x 2 flash
    forward launches a step (the replay), 144 of each backward kernel (all
    ``wgmma``) and 4 hot-slab launches, counted from zero over the steps;
    every loss finite, the last half's mean below the first half's (the
    last 2 against the first 2), and, on one
    microbatch first, no gradient leaf all zero; then ``torch.profiler``
    over one more step: the device's busy share and its ten costliest
    device operations. Then one microbatch's loss and
    gradients on the card against the CPU, the width cut to 2 layers, 1 x
    512 tokens (the loss within 1e-2, each leaf within 5e-2 relative L2;
    the CPU's half in a pool worker from the start of phase 14);
    then, on the card, the same gradients with remat off, bit for bit.
    The full-depth run saves no checkpoint (the resume test through
    ``launch/train.main`` runs on zamba2-1.2b and smoke mixtral below).

    Then, after qwen's model is freed, paligemma-3b
    (`prefix_train_phase`) at full width and depth (18 layers,
    2,508,660,736 parameters, remat on), trained as qwen is for
    `TRAIN_STEPS` steps: 8 x 4,096 positions a step, each sequence
    a 256-row prefix of zero embeddings (as the reference's trainer builds
    it) and 3,840 corpus tokens; 18 x 4 x 2 grouped, prefix-masked flash
    forward launches a step and 72 of each backward kernel, all
    ``wgmma`` at d 256; the same checks and profile. Then its card
    against the CPU at 2 layers on 256 prefix rows from N(0, 1) plus 256
    tokens, with remat's bits; then ``launch/train.main --arch
    paligemma-3b --depth 2 --seq-len 320 --no-final-ckpt`` for 3 steps
    (the trainer's own prefix batch; finite losses; 12 ``wgmma`` backward
    launches; no checkpoint).

    Then, after qwen's model is freed, MoE training (`moe_train_phase`).
    ``tgmm``, the grouped matmul's weight-gradient kernel
    (``gmm_bf16_tgmm``), against its plain version at the smoke, served
    and K 136 / N 200 widths and M 333, with empty groups, one group
    holding every row, rows past the total and two groups holding all
    rows (float32 at rtol/atol 1e-4, the bf16 result that one rounded, a
    repeat's bits equal), and dX and dW through ``ragged_dot``'s autograd
    Function at two of them. moonshot-v1-16b-a3b at full width, 4 of its
    48 layers (3,022,536,704 parameters), trained as qwen is (remat on,
    `TRAIN_STEPS` steps of 8 x 4,096 tokens in microbatches of 2, one
    profiled step):
    each layer a microbatch launches 3 ``moe_gmm`` (``wgmma``) in the
    forward, 3 in the replay and 3 for dX, and 3 ``tgmm``: 144 and 48 a
    step, asserted; no gradient leaf all zero on the first microbatch,
    whose layer-0 weight-gradient operands (its real expert-sorted rows
    and dY) are kept: layer 0's group sizes, ``tgmm`` and dX held to
    their plain versions on them, and ``tgmm`` timed there at the gate
    and down products beside its plain version, its bound (2.835e11
    FLOPs at the bf16 rate, 0.287 ms) and ``torch._grouped_mm(xT, dY,
    offs=)`` (timed only), and dX through ``gmm`` reading the expert
    stack transposed, beside a transposed copy and ``gmm`` on it. Then 2
    layers at full width, 1 x 512 tokens, remat on in both runs: the
    card, replaying the CPU's expert choices (``models.moe.RouteTape``),
    against the CPU (loss 1e-2, each leaf 5e-2 relative L2, none all
    zero), and on the card remat on against off over the same
    parameters, its own routing: the replay routes as the forward did and
    every gradient is equal bit for bit.
    Then smoke moonshot's checkpoint tree (params and AdamW moments)
    through save, restore and ``load_state`` on the card, bit for bit
    (the MoE's resume test runs on smoke mixtral below).

    Then the configs phase 13 serves last (`wide_train_phase`):
    chatglm3-6b (group 16, half rotary, q/k/v biases), starcoder2-7b
    (group 9, layernorm, biased tanh-GELU MLP, output bias) and
    mixtral-8x7b (group 4, window 4,096, 8 experts of 14,336, top 2), each
    at full width and its depth cut to the deepest whose training peak
    stays under about 62 GiB (`TRAIN_DEPTH`; printed as a cut with the
    parameters and the peak), trained as the recurrent trunks are below
    (`RECURRENT_TRAIN_STEPS` steps, a profiled microbatch, no gradient
    leaf all zero, the loss falling, the launches by kv group and
    windowed asserted: mixtral's 3 ``tgmm`` a layer a microbatch); for
    mixtral ``tgmm`` and dX held to their plain versions on layer 0's
    real rows (16,384 a microbatch over 8 experts) and timed there beside
    the bound and ``torch._grouped_mm``; each one's card against the CPU
    (chatglm3-6b and starcoder2-7b at 2 layers, `train_card_vs_cpu`;
    mixtral at 1 layer, 1.71e9 parameters, on the CPU's replayed routing,
    `moe_train_card_vs_cpu`) with remat's bits; and the resume test on
    smoke mixtral (a full-width save of one of its layers is about 20
    GB).

    Then the recurrent trunks (`recurrent_train_phase`): rwkv6-3b (32
    layers, no attention) and zamba2-1.2b (38 Mamba2 layers, the shared
    block at 6 of them) each at full width and depth, trained as qwen is
    but for `RECURRENT_TRAIN_STEPS` steps and a profiled step of one
    microbatch: the wkv and SSD scans' gradients through their chunked
    forms and state loops; zamba2's shared block 6 x 4 x 2 flash forward
    launches a step and 24 of each backward kernel (``wgmma`` at d 64); 4
    hot-slab launches a step for each. Then each one's card against the
    CPU at 2 layers (zamba2's cut keeps its shared block), its decay
    path's leaves printed by name: rwkv6-3b's bf16 gradients at that cut
    are chaotic (grad_witness.py), so its runs there take the compute
    dtype float32 (`F32_GRAD_ARCHS`), and it is held in bf16 at 1 layer
    too; remat on against off bit for bit in bf16; zamba2's resume test
    at ``--depth 2``, full width (the only full-width resume: those of
    qwen2.5-3b and rwkv6-3b at 2 layers, about 27 s each, ran the same
    path). Phases 7-11's `time_scan`
    times each scan's forward plus backward at the prefill and at a
    training microbatch.

The line before the last is the ``kernels`` JSON object; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import pathlib
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 7
NUM_VERTICES = 1_000_000
SPMV_TOL = dict(rtol=1e-5, atol=1e-6)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12               # H100 SXM float32 outside tensor cores
BF16_FLOPS = 989e12             # H100 SXM bf16 dense tensor cores
ARCH = "minicpm-2b"
GQA_ARCH = "qwen2.5-3b"
PREFIX_ARCH = "paligemma-3b"    # prefix-LM, one kv head, head dim 256
ENCODER_ARCH = "hubert-xlarge"  # bidirectional encoder, head dim 80
RWKV_ARCH = "rwkv6-3b"          # attention-free: time-mix + channel-mix
HYBRID_ARCH = "zamba2-1.2b"     # Mamba2 with a shared attention block
GLM_ARCH = "chatglm3-6b"        # group 16, half rotary, q/k/v biases
CODE_ARCH = "starcoder2-7b"     # group 9, layernorm, biased GELU MLP
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_LAYERS = 16                 # of 48: what one 80 GB card holds in f32
SWA_ARCH = "mixtral-8x7b"       # window 4,096, group 4, top 2 of 8 experts
SWA_LAYERS = 8                  # of 32: 43.2 GiB of f32 masters
RING_STEPS = 24                 # smoke mixtral's decode: 3 laps of its ring
POOL_WORKERS = 4                # the run's process pool (oracles, corpora,
                                # the CPU's halves of phases 9 and 14)
# phase 10 serves these earlier configs on the first `SERVE_LAYERS` of
# their layers (their weights, `serve_view`), to keep the run inside its
# time limit: a decode step is bound by the host, about 2-7 ms a layer
SERVE_CUT = (ARCH, GQA_ARCH, PREFIX_ARCH, RWKV_ARCH, HYBRID_ARCH, MOE_ARCH)
SERVE_LAYERS = 8
PREFILL_SHAPE = "prefill_32k"   # configs/shapes.py; its batch of 32 cut to 1
PREFILL_TOKENS = None           # None: SHAPES[PREFILL_SHAPE].seq_len
FLASH_TOL = {"float32": dict(rtol=1e-3, atol=2e-3),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}
FLASH_SERVED_TOL = dict(rtol=1.6e-2, atol=1e-2)   # bf16, served shapes
# bf16 masks and head dims 80 / 256: the kernel and the plain version both
# keep PV in float32 and round once, so they part by at most one bf16 unit
# of the output (2^-7 of it); atol covers outputs near zero
FLASH_MASK_TOL = dict(rtol=8e-3, atol=1e-3)
DECODE_TOL = dict(rtol=0.15, atol=0.15)
GMM_TOL = dict(rtol=1e-4, atol=1e-4)   # float32 sums of exact products
ROUTE_TIE = 1e-3        # router margin (probability) that rounding can cross
SWEEP_TOKENS = (4, 8, 16, 64, 256, 768, 1024, 4096, 32_768)   # phase 13
TRAIN_ARCH = GQA_ARCH           # phase 14: the reference trainer's default
TRAIN_SEQ = 4096                # configs/shapes.py's train_4k
TRAIN_BATCH = 8                 # train_4k's global batch of 256, cut to 8
TRAIN_MICROBATCH = 2
TRAIN_STEPS = 4                 # 6 before the last three configs trained
MOE_TRAIN_LAYERS = 4            # phase 14: moonshot trained, 4 of 48 layers
MOE_GRAD_LAYERS = 2             # its card-vs-CPU and remat-bits checks
# phase 14: chatglm3-6b, starcoder2-7b and mixtral-8x7b trained at full
# width, each at the deepest cut whose training peak stays under about
# 62 GiB (float32 masters, gradients and both AdamW moments take 16 B a
# parameter: 3.04, 3.23 and 21.63 GiB a layer; peaks measured at 13, 12
# and 2 layers: 51.5, 49.9 and 58.9 GiB), and their card-vs-CPU depths
# (mixtral's one layer holds 1.71e9 parameters)
TRAIN_DEPTH = {GLM_ARCH: 16, CODE_ARCH: 15, SWA_ARCH: 2}
WIDE_GRAD_LAYERS = {GLM_ARCH: 2, CODE_ARCH: 2, SWA_ARCH: 1}
# phase 14: rwkv6-3b and zamba2-1.2b, fewer than `TRAIN_STEPS` to keep the
# run inside its time limit (a step of rwkv6-3b takes 13-17 s, zamba2's
# 6), the falling-loss gate then the last loss against the first, and
# their profiled step one microbatch of `TRAIN_MICROBATCH` sequences (the
# profiler takes 31 s to hand over a full step's 458,481 device operations)
RECURRENT_TRAIN_STEPS = 2
# the recurrent trunks' decay path: the leaves whose gradients in-place
# writes in the chunked scans once corrupted (printed by name)
DECAY_LEAVES = ("dec_w1", "dec_w2", "w_base", "a_log", "dt_bias")
# archs whose bf16 gradients at 2 layers of full width and random weights
# are chaotic: the CPU's own move by up to 5e-2 relative L2 when every
# weight is multiplied by 1 + 1e-6 N(0, 1), 8.7e-3 at 1 layer
# (grad_witness.py). Their card against CPU runs at 2 layers with the
# compute dtype float32 in both, and in bf16 at 1 layer (no flash kernel
# on rwkv6-3b's path)
F32_GRAD_ARCHS = (RWKV_ARCH,)
# phase 14's card-against-CPU gradient checks, (arch, layers): their CPU
# halves run in pool workers from the start of phase 14 (`host_grads`)
GRAD_CHECKS = ((TRAIN_ARCH, 2), (PREFIX_ARCH, 2), (MOE_ARCH, MOE_GRAD_LAYERS),
               *WIDE_GRAD_LAYERS.items(), (RWKV_ARCH, 2), (RWKV_ARCH, 1),
               (HYBRID_ARCH, 2))
# the backward checks: (BH, KV, S, d, prefix, window) of a qwen2.5-3b
# microbatch (2 x 16 heads over 2 x 2 kv heads, d 128, causal), a
# minicpm-2b one (2 x 36, d 64), a paligemma-3b one (2 x 8 heads over 2
# x 1 kv head, d 256, causal with its 256-row prefix), one of
# zamba2-1.2b's shared block (2 x 32, d 64, causal), a chatglm3-6b one
# (2 x 32 over 2 x 2, group 16), a starcoder2-7b one (2 x 36 over 2 x 4,
# group 9) and mixtral-8x7b's (2 x 32 over 2 x 8, group 4, window 4,096)
# at S 8,192 + 77, where the window cuts (at train_4k's 4,096 it masks
# nothing)
BWD_SHAPES = ((32, 4, 4096, 128, 0, 0), (72, 72, 4096, 64, 0, 0),
              (16, 2, 4096, 256, 256, 0), (64, 64, 4096, 64, 0, 0),
              (64, 4, 4096, 128, 0, 0), (72, 8, 4096, 128, 0, 0),
              (64, 16, 8269, 128, 0, 4096))
BWD_NAMES = ("qwen2.5-3b microbatch, GQA", "minicpm-2b microbatch, MHA",
             "paligemma-3b microbatch, d 256, prefix",
             "zamba2-1.2b microbatch, shared block, MHA",
             "chatglm3-6b microbatch, group 16",
             "starcoder2-7b microbatch, group 9",
             "mixtral-8x7b microbatch heads, window 4,096 at S 8,269")
# the timings: the checks' shapes, mixtral's at S 16,384, where the window
# lets 58,722,304 of a head's 134,225,920 causal pairs through, and the
# same without the window beside it
BWD_TIMING = (*BWD_SHAPES[:-1], (64, 16, 16384, 128, 0, 4096),
              (64, 16, 16384, 128, 0, 0))
# the mma.sync pair's check, at qwen2.5-3b's microbatch with d 32
BWD_MMA_SYNC_SHAPE = (32, 4, 4096, 32, 0, 0)
SHARDS = 4                      # phase 4s: phase 4's graph in 4 shards
# phase 15: the LM on meshes of 4 shards of cuda:0
MESH_AXES = ("data", "model")
MESH_ARCH = GQA_ARCH
MESH_LAYERS = 8                 # of 36, as phase 10 cuts (`SERVE_LAYERS`)
MESH_SERVE = (1, 4)             # (a): kv 2 does not divide 4: seq-sharded
MESH_TRAIN = (2, 2)             # (b) and (c): FSDP x TP
MESH_LR = 1e-3                  # (b), (c): constant, so the update shows
# (a)'s decode: rows, cache length (divisible by 4), the positions filled
# with random K/V before it (into the third sequence shard), steps
MESH_DECODE = {"batch": 4, "cache": 4096, "filled": 3000, "steps": 16}
MESH_MOE_LAYERS = 2             # (c): moonshot, 2 of 48 layers
MESH_MOE_PREFILL = 4096         # (c)'s prefill: 1 row, cut over data
MESH_MOE_TRAIN = (4, 1024)      # (c)'s train step: rows x tokens
MESH_MOE_GRAD_LAYERS = 1        # (c)'s card against the CPU
MESH_MOE_GRAD = (2, 256)
# phase 4's oracles in two worker processes, about equal in host time
ORACLE_PARTS = ("cc", "rest")
# k-NN: SIFT1M's width (d 128) with 16,384 of its 1,000,000 base vectors:
# the host NSW builder takes about 9 ms an insert
KNN_VECTORS, KNN_DIM, KNN_K = 16_384, 128, 16
KNN_QUERIES = 1024
KNN_RECALL = 0.95     # tests/test_search.py:164, on its own corpus
KNN_AGREE = 0.99      # float corpus: rows equal to the host oracle's


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 3, queued: bool = False) -> float:
    """Mean device milliseconds per call, from CUDA events. ``queued``
    first parks the device in a 10 ms sleep, so that every call is
    enqueued before the first one runs: a call whose host cost nears its
    device time cannot then leave the device idle between calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(20_000_000)   # about 10 ms of clock cycles
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def spmv_check(name, t_indptr, t_indices, val, x) -> float:
    """Kernel vs plain version on the same card tensors; returns max |err|.
    The plain version sums in float64 and rounds once: in float32 its
    ``index_add_`` adds a row's products in the atomics' order, which
    changes from run to run, and over phase 3's 100,000-edge hub row it
    once strayed 1.39e-5 relative from the kernel, past `SPMV_TOL`; the
    kernel's tiled sums stray far less from the exact sum."""
    import torch
    from repro_torch.kernels.csr_spmv import csr_spmv as spmv
    from repro_torch.kernels.csr_spmv.ref import csr_spmv_ref
    got = spmv.csr_spmv(t_indptr, t_indices, val, x)
    again = spmv.csr_spmv(t_indptr, t_indices, val, x)
    want = csr_spmv_ref(t_indptr, t_indices, val.double(),
                        x.double()).to(x.dtype)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"csr_spmv[{name}]: two runs differ")
    torch.testing.assert_close(got, want, **SPMV_TOL)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    print(f"csr_spmv[{name}]: rows={got.numel()} "
          f"edges={int(t_indptr[-1])} max_abs_err={err:.3e}")
    return err


def kernel_cases(dev) -> float:
    """Phase 3: the edge cases of tests/test_csr_spmv.py, on the card."""
    import numpy as np
    import torch
    from repro_torch.algos.graph_arrays import to_device
    from repro_torch.core.csr import from_edges
    from repro_torch.core.generators import powerlaw_community
    from repro_torch.engine.backends import bucket_dims
    from repro_torch.kernels.csr_spmv import csr_spmv as spmv

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(n):
        return torch.rand(n, generator=gen, device=dev)

    def in_csr(g):
        t = g.transpose
        return (torch.from_numpy(np.asarray(t.indptr, np.int32)).to(dev),
                torch.from_numpy(np.asarray(t.indices, np.int32)).to(dev))

    errs = []
    g = powerlaw_community(20_000, avg_degree=12.0, mixing=0.12, seed=SEED)
    ip, ix = in_csr(g)
    errs.append(spmv_check("ragged", ip, ix, rand(ix.numel()),
                           rand(g.num_vertices)))
    g = from_edges(600, [0, 1, 2], [5, 5, 515])
    ip, ix = in_csr(g)
    errs.append(spmv_check("empty_rows", ip, ix, torch.ones(3, device=dev),
                           rand(600)))
    g = from_edges(17, np.array([], np.int64), np.array([], np.int64))
    ip, ix = in_csr(g)
    errs.append(spmv_check("no_edges", ip, ix,
                           torch.ones(0, device=dev), rand(17)))
    g = powerlaw_community(3000, avg_degree=8.0, seed=11)
    ga = to_device(g, pad_to=bucket_dims(g.num_vertices, g.num_edges),
                   device=dev)
    errs.append(spmv_check("sentinels", ga.t_indptr, ga.t_indices,
                           ga.edge_valid.to(torch.float32),
                           rand(ga.num_vertices)))

    # a 100k-edge hub: its edges cross many blocks' shares
    rng = np.random.default_rng(SEED)
    n = 2000
    g = from_edges(n, rng.integers(0, n, 103_000),
                   np.concatenate([np.zeros(100_000, np.int64),
                                   rng.integers(1, n, 3000)]))
    ip, ix = in_csr(g)
    errs.append(spmv_check("hub_100k", ip, ix, rand(ix.numel()), rand(n)))
    # a bucketed upload, whole: the sentinel row holds half the edges;
    # then its real rows only, as PR's relaxation passes them
    g = powerlaw_community(200_000, avg_degree=12.0, seed=SEED)
    ga = to_device(g, pad_to=bucket_dims(g.num_vertices, g.num_edges),
                   device=dev)
    val = ga.edge_valid.to(torch.float32)
    errs.append(spmv_check("bucket_full", ga.t_indptr, ga.t_indices, val,
                           rand(ga.num_vertices)))
    v = g.num_vertices
    errs.append(spmv_check("bucket_prefix", ga.t_indptr[:v + 1],
                           ga.t_indices, val, rand(v)))
    # rows of 512 edges and empty rows, ending on every 2,048-edge chunk
    # boundary and every block's share (8 rows of 512 edges and one empty
    # row a block: 4,105 items)
    blocks = spmv.blocks(torch.cuda.current_device())
    deg = np.tile([512] * 8 + [0], blocks)
    ip = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                          .astype(np.int32)).to(dev)
    ix = torch.randint(0, deg.size, (int(deg.sum()),), generator=gen,
                       device=dev, dtype=torch.int32)
    errs.append(spmv_check("boundaries", ip, ix, rand(ix.numel()),
                           rand(deg.size)))
    # one vertex with 5,000 self-loops
    ip = torch.tensor([0, 5000], dtype=torch.int32, device=dev)
    errs.append(spmv_check("one_vertex", ip,
                           torch.zeros(5000, dtype=torch.int32, device=dev),
                           rand(5000), rand(1)))
    # views at 4-byte, not 16-byte, offsets
    g = powerlaw_community(20_000, avg_degree=12.0, mixing=0.12, seed=SEED)
    ip, ix = in_csr(g)
    e = ix.numel()
    ipv = torch.empty(ip.numel() + 2, dtype=torch.int32, device=dev)[2:]
    ixv = torch.empty(e + 1, dtype=torch.int32, device=dev)[1:]
    valv = torch.empty(e + 3, device=dev)[3:]
    ipv.copy_(ip)
    ixv.copy_(ix)
    valv.copy_(rand(e))
    if any(t.data_ptr() % 16 == 0 for t in (ipv, ixv, valv)):
        raise AssertionError("the views must not be 16-byte aligned")
    errs.append(spmv_check("views", ipv, ixv, valv, rand(g.num_vertices)))
    return max(errs)


def served_graph(num_vertices: int):
    """Phase 4's graph (the ``lj-sim`` recipe, seed `SEED`) and the 4
    sources of each multi-source kernel."""
    import numpy as np
    from repro_torch.core.generators import powerlaw_community
    g = powerlaw_community(num_vertices, avg_degree=14.0, mixing=0.12,
                           seed=SEED)
    rng = np.random.default_rng(SEED)
    sources = {k: rng.choice(g.num_vertices, 4, replace=False)
               for k in ("bfs", "sssp", "bc")}
    return g, sources


def graph_oracles(num_vertices: int, part: str) -> dict:
    """The numpy oracles' answers on phase 4's graph (`served_graph`),
    made on the host in a process of their own, started with the run, so
    that they overlap the phases before them: ``part`` (`ORACLE_PARTS`)
    "cc" CC's and CC-SV's labels, "rest" BFS's, SSSP's, BC's and PR's;
    and the seconds they took."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.algos.graph_arrays import edge_weights
    from repro_torch.core import baselines as B
    t0 = time.perf_counter()
    g, sources = served_graph(num_vertices)
    if part == "cc":
        labels = B.cc_baseline(g)
        out = {"cc": labels, "ccsv": labels}
    else:
        weights = edge_weights(g.edge_src, g.indices)
        out = {"bfs": [B.bfs_baseline(g, s) for s in sources["bfs"]],
               "sssp": [B.sssp_baseline(g, weights, s)
                        for s in sources["sssp"]],
               "bc": [B.bc_baseline(g, [s]) for s in sources["bc"]],
               "pr": B.pagerank_baseline(g)}
    return {**out, "seconds": time.perf_counter() - t0}


def serve(dev, num_vertices: int, oracles: list) -> dict:
    """Phase 4: the port's main path, checked against the numpy oracles
    (``oracles``: futures of `graph_oracles`' parts)."""
    import numpy as np
    from repro_torch.engine import EngineSession
    from repro_torch.kernels.csr_spmv import csr_spmv as spmv

    t0 = time.perf_counter()
    g, sources = served_graph(num_vertices)
    print(f"graph: V={g.num_vertices} E={g.num_edges} "
          f"generated in {time.perf_counter() - t0:.1f} s")
    session = EngineSession(device=dev)
    t0 = time.perf_counter()
    gid = session.register(g, graph_id="lj-sim", expected_queries=4096)
    entry = session.registry.get(gid)
    print(f"registered in {time.perf_counter() - t0:.1f} s: "
          f"bucket={entry.bucket_shape} "
          f"device_bytes={entry.handle.device_bytes}")
    print(f"decision: {entry.decision}")

    kernels = ("bfs", "sssp", "bc", "pr", "cc", "ccsv")
    perm = entry.perm
    spmv.launches = 0
    futures = {k: session.enqueue(gid, k, sources.get(k)) for k in kernels}
    t0 = time.perf_counter()
    session.flush()
    served_s = time.perf_counter() - t0
    launches = {"csr_spmv": spmv.launches}
    out = {k: np.asarray(f.result()) for k, f in futures.items()}
    print(f"served {len(kernels)} requests in {served_s:.3f} s")
    m = session.metrics()
    walls = {}
    for k in kernels:
        h = m.histogram("engine_launch_wall_seconds", "device wall per launch",
                        kernel=k, backend="single")
        walls[k] = h.sum
        print(f"launch wall {k}: {h.sum:.4f} s over {h.count} launch(es)")
    if launches["csr_spmv"] <= 0:
        raise AssertionError("the PR request did not launch csr_spmv")
    print(f"csr_spmv launches during the PR request: {launches['csr_spmv']}")
    # a warm launch of each through the backend, past the result cache
    # (phase 4s holds its warm sharded launches beside these)
    warm = {}
    for k in kernels:
        srcs = sources.get(k)
        t0 = time.perf_counter()
        session.executor.single.run(entry.handle, k,
                                    None if srcs is None else entry.perm[srcs])
        warm[k] = time.perf_counter() - t0
        print(f"warm launch {k}: {warm[k]:.4f} s")
    spmv.launches = launches["csr_spmv"]  # the warm PR is not the main path's

    t0 = time.perf_counter()
    parts = [f.result() for f in oracles]
    want = {k: v for part in parts for k, v in part.items()}
    for i in range(len(sources["bfs"])):
        np.testing.assert_array_equal(out["bfs"][i], want["bfs"][i])
    for i in range(len(sources["sssp"])):
        np.testing.assert_array_equal(out["sssp"][i].astype(np.int64),
                                      want["sssp"][i])
    for i in range(len(sources["bc"])):
        np.testing.assert_allclose(out["bc"][i], want["bc"][i], rtol=1e-3,
                                   atol=1e-3)
    np.testing.assert_allclose(out["pr"], want["pr"], rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(out["cc"], want["cc"])
    np.testing.assert_array_equal(out["ccsv"], want["ccsv"])
    for k in kernels:
        print(f"{k}: shape={out[k].shape} dtype={out[k].dtype} "
              f"matches the numpy oracle")
    made = " and ".join(f"{p['seconds']:.1f}" for p in parts)
    print(f"oracles made in {made} s in worker processes beside the "
          f"phases before; waited {time.perf_counter() - t0:.1f} s for "
          f"them, checked")
    return {"session": session, "entry": entry, "launches": launches,
            "graph": g, "sources": sources, "answers": out, "walls": walls,
            "warm": warm}


def time_spmv(entry) -> tuple[dict, float]:
    """Phase 5: csr_spmv at the served shapes, beside plain and library."""
    import torch
    from repro_torch.kernels.csr_spmv import csr_spmv as spmv
    from repro_torch.kernels.csr_spmv.ref import csr_spmv_ref

    ga, n = entry.handle.arrays, entry.handle.num_vertices
    e = entry.handle.num_edges
    ip = ga.t_indptr[:n + 1]
    ix, val = ga.t_indices, entry.handle.spmv_val
    gen = torch.Generator(device=ga.device).manual_seed(SEED)
    x = torch.rand(n, generator=gen, device=ga.device)
    err = spmv_check("served", ip, ix, val, x)
    kept = spmv.launches
    ms = cuda_ms(lambda: spmv.csr_spmv(ip, ix, val, x), reps=50)
    plain_ms = cuda_ms(lambda: csr_spmv_ref(ip, ix, val, x), reps=20)
    mat = torch.sparse_csr_tensor(ip, ix[:e], val[:e], size=(n, n),
                                  check_invariants=True)
    library_ms = cuda_ms(lambda: mat @ x, reps=50)
    host = host_ms(lambda: spmv.csr_spmv(ip, ix, val, x))
    spmv.launches = kept  # timing launches are not the main path's
    nbytes = 4 * (n + 1) + 8 * e + 4 * n + 4 * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * e / F32_FLOPS * 1e3
    print(f"csr_spmv timing: rows={n} edges={e} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={max(bytes_ms, ops_ms):.4f} ({nbytes} bytes) "
          f"host_ms={host:.4f}")
    return ({"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "host_ms": host},
            err)


# ------------------------------------------------- phase 4s: sharded serve
def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_serve(dev, single: dict, corpora: dict, card: str) -> dict:
    """Phase 4s: phase 4's graph served in ``SHARDS`` shards on the card.

    ``EngineSession(num_shards=SHARDS)`` with a device budget below the
    graph's single-device bytes: the policy itself places it sharded and
    picks its ``hot_prefix_fraction``. BFS, SSSP and BC (phase 4's
    sources), PR, CC and CC-SV are held to phase 4's single-device
    answers (bit for bit; PR rtol 1e-4, BC 1e-3). Then the min-relaxation
    runners (BFS, SSSP, CC) with the hot prefix off and on, over the
    graph in the policy's order and in its original order: the answers
    equal, the exchange ledger, ``prefix_hit_rate`` and wall printed, and
    with the prefix on 0 < savings < 1. Last, one k-NN batch on the
    integer corpus through a sharded session, ids equal to a
    single-device session's. ``single`` is what `serve` returned."""
    import numpy as np
    from repro_torch.core import dist
    from repro_torch.engine import EngineSession, estimate_device_bytes
    from repro_torch.engine.backends import bucket_dims
    from repro_torch.engine.scheduler import canonical_component_labels
    from repro_torch.kernels.csr_spmv import csr_spmv as spmv

    g, sources, want = single["graph"], single["sources"], single["answers"]
    v_b, e_b = bucket_dims(g.num_vertices, g.num_edges)
    budget = estimate_device_bytes(v_b, e_b) // 2
    session = EngineSession(device=dev, num_shards=SHARDS,
                            device_budget_bytes=budget)
    t0 = time.perf_counter()
    gid = session.register(g, graph_id="lj-sim-sharded",
                           expected_queries=4096)
    entry = session.registry.get(gid)
    sharded = session.executor.sharded
    print(f"sharded: registered in {time.perf_counter() - t0:.1f} s, "
          f"budget {budget} bytes, backend {entry.backend}, "
          f"{sharded.num_shards} shards on "
          f"{[str(d) for d in sharded.mesh.devices]}, "
          f"per-device bytes {entry.handle.device_bytes} (single-device "
          f"{estimate_device_bytes(v_b, e_b)})")
    print(f"sharded decision: {entry.decision}")
    if entry.backend != "sharded" or entry.hot_prefix_fraction is None:
        raise AssertionError("the policy did not place the graph sharded "
                             "with a hot prefix")

    kernels = ("bfs", "sssp", "bc", "pr", "cc", "ccsv")
    perm = entry.perm
    spmv.launches = 0
    futures = {k: session.enqueue(gid, k, sources.get(k)) for k in kernels}
    t0 = time.perf_counter()
    session.flush()
    served_s = time.perf_counter() - t0
    out = {k: np.asarray(f.result()) for k, f in futures.items()}
    # the sharded PR gathers and sums in torch, as the reference's does
    # in XLA: no kernel of the port is on this path
    print(f"sharded: served {len(kernels)} requests in {served_s:.3f} s; "
          f"csr_spmv launches {spmv.launches}")
    m = session.metrics()
    walls, exchange = {}, {}
    for k in kernels:
        h = m.histogram("engine_launch_wall_seconds", "device wall per launch",
                        kernel=k, backend="sharded")
        walls[k] = h.sum
        exchange[k] = futures[k].telemetry["exchange"]
        print(f"sharded launch wall {k}: {h.sum:.4f} s; exchange "
              f"{json.dumps(exchange[k])} [{card}]")
    for k in ("bfs", "sssp", "cc", "ccsv"):
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)
    np.testing.assert_allclose(out["pr"], want["pr"], rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(out["bc"], want["bc"], rtol=1e-3, atol=1e-3)
    print("sharded: BFS, SSSP, CC and CC-SV equal phase 4's answers bit "
          "for bit, PR within rtol 1e-4, BC within 1e-3")
    print(f"sharded telemetry: {json.dumps(sharded.telemetry())}")
    # a kernel's first sharded launch partitions and uploads its edges
    # (the single-device upload is paid at registration): launch again
    # through the backend, past the result cache, for the warm wall
    warm = {}
    for k in kernels:
        srcs = sources.get(k)
        t0 = time.perf_counter()
        sharded.run(entry.handle, k, None if srcs is None else perm[srcs])
        warm[k] = time.perf_counter() - t0
        print(f"sharded warm launch {k}: {warm[k]:.4f} s (first "
              f"{walls[k]:.4f} s); single-device warm "
              f"{single['warm'][k]:.4f} s (first {single['walls'][k]:.4f} s)"
              f" [{card}]")

    # the paper's locality effect on the exchange: the min-relaxation
    # runners, hot prefix off and on, in the policy's and the original
    # order (policy-order answers mapped back to original ids)
    f = entry.hot_prefix_fraction
    orders = {"policy": (entry.served, entry.inv_perm, perm),
              "original": (g, None, None)}
    ledger = {}
    for order, (graph, canon, to_served) in orders.items():
        for frac in (None, f):
            for k in ("bfs", "sssp", "cc"):
                stats = dist.ExchangeStats()
                kw = dict(hot_prefix_fraction=frac,
                          cold_every=sharded.cold_every, stats=stats)
                t0 = time.perf_counter()
                if k == "sssp":
                    run = dist.make_distributed_sssp(
                        graph, sharded.mesh, canonical_ids=canon, **kw)
                elif k == "bfs":
                    run = dist.make_distributed_bfs(graph, sharded.mesh, **kw)
                else:
                    run = dist.make_distributed_cc(graph, sharded.mesh, **kw)
                srcs = sources[k] if k != "cc" else None
                if to_served is not None and srcs is not None:
                    srcs = to_served[srcs]
                _sync(dev)
                built_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                got = run(srcs) if srcs is not None else run()
                _sync(dev)
                wall = time.perf_counter() - t0
                got = got.cpu().numpy()
                if to_served is not None:
                    got = got[..., to_served]
                if k == "cc":
                    got = canonical_component_labels(got)
                np.testing.assert_array_equal(got, want[k],
                                              err_msg=f"{order} {k} {frac}")
                d = stats.as_dict()
                ledger[f"{order} {k} prefix={frac}"] = {
                    **d, "prefix_hit_rate": run.prefix_hit_rate,
                    "h_local": run.h_local, "per": run.per, "wall_s": wall,
                    "build_s": built_s}
                print(f"exchange [{order} order, {k}, hot prefix {frac}]: "
                      f"{json.dumps(d)} prefix_hit_rate "
                      f"{run.prefix_hit_rate:.4f} h_local {run.h_local} of "
                      f"{run.per}, wall {wall:.4f} s (partitioned and "
                      f"uploaded in {built_s:.1f} s) [{card}]")
                if frac is not None and not 0 < d["savings_fraction"] < 1:
                    raise AssertionError(f"{order} {k}: the hot prefix saved "
                                         f"{d['savings_fraction']}")
    session.close()

    built = corpora["integer"].result()
    ivecs, ig = built["vectors"], built["graph"]
    iq = np.random.default_rng(SEED + 2).integers(0, 12, (64, 16)).astype(
        np.float32)
    ids = {}
    for placement, kw in (("single", {}),
                          ("sharded", dict(num_shards=SHARDS,
                                           device_budget_bytes=1))):
        with EngineSession(device=dev, **kw) as s:
            kid = s.register(ig, "knn-int", vectors=ivecs)
            if s.registry.get(kid).backend != placement:
                raise AssertionError(f"knn: not placed {placement}")
            ids[placement] = s.submit(kid, "knn", iq)
    np.testing.assert_array_equal(ids["sharded"], ids["single"])
    print(f"sharded knn: {len(iq)} queries on the integer corpus over "
          f"{SHARDS} shards, ids equal the single-device session's")
    return {"walls": walls, "warm": warm, "exchange": exchange,
            "ledger": ledger,
            "per_device_bytes": entry.handle.device_bytes,
            "hot_prefix_fraction": f}


# ------------------------------------------------------------------ k-NN
def search_corpus(kind: str, num_vectors: int = KNN_VECTORS,
                  num_queries: int = KNN_QUERIES) -> dict:
    """A k-NN corpus, its NSW graph and its host oracles, made on the
    host. Runs in a process of its own, started with the run, so that it
    overlaps the graph phases.

    ``clustered``: `clustered_vectors(16_384, dim=128, num_clusters=64,
    seed=1)`, NSW k 16, and for its ``num_queries`` queries (seed 0) the
    host beam search's ids and visits (`knn_search_baseline`, the
    reference's search in float32 at the default beam) and the
    brute-force ids. ``integer``: 2,048 integer-valued vectors of d 16 in
    [0, 12) (exact float32 distances), NSW k 8. ``reference``:
    tests/test_search.py's corpus (240 x 8, 5 clusters, NSW k 8)."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.baselines import knn_search_baseline
    from repro_torch.core.generators import clustered_vectors
    from repro_torch.search import (build_nsw_graph, knn_brute_force,
                                    medoid_entry)
    t0 = time.perf_counter()
    if kind == "clustered":
        vecs, _ = clustered_vectors(num_vectors, dim=KNN_DIM,
                                    num_clusters=64, seed=1)
        k = KNN_K
    elif kind == "integer":
        vecs = np.random.default_rng(SEED).integers(0, 12, (2048, 16)).astype(
            np.float32)
        k = 8
    else:
        vecs, _ = clustered_vectors(240, dim=8, num_clusters=5, seed=1)
        k = 8
    out = {"vectors": vecs, "graph": build_nsw_graph(vecs, k=k),
           "seconds": time.perf_counter() - t0}
    if kind == "clustered":
        t0 = time.perf_counter()
        queries = knn_queries(vecs, num_queries, seed=0)
        start = medoid_entry(vecs)
        host = [knn_search_baseline(out["graph"], vecs, q, start)
                for q in queries]
        out.update(host_ids=np.stack([h[0] for h in host]),
                   host_visits=sum(int(h[1].sum()) for h in host),
                   brute=knn_brute_force(vecs, queries, 10),
                   oracle_seconds=time.perf_counter() - t0)
    return out


def knn_queries(vecs, n: int, seed: int):
    """Corpus rows plus N(0, 0.01) jitter (tests/test_search.py's
    queries)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    q = vecs[rng.integers(0, len(vecs), n)]
    return (q + rng.normal(0, 0.01, q.shape)).astype(np.float32)


def knn_phase(dev, corpora: dict, card: str) -> dict:
    """k-NN search served through ``EngineSession`` on the card: recall@10
    against brute force on the clustered corpus, the host oracle's ids and
    visits on the integer one, the same ids across the identity,
    visit-sorted and patched layouts and on a repeat; the launch walls."""
    import numpy as np
    import torch
    from repro_torch.algos import kernels as K
    from repro_torch.core.baselines import knn_search_baseline
    from repro_torch.engine import EngineSession
    from repro_torch.search import knn_brute_force, medoid_entry

    def recall(got, want):
        return float(np.mean([len(set(a) & set(b)) / want.shape[1]
                              for a, b in zip(got.tolist(), want.tolist())]))

    built = corpora["reference"].result()
    with EngineSession(device=dev) as s0:
        vecs = built["vectors"]
        gid = s0.register(built["graph"], "knn-reference", vectors=vecs)
        q = knn_queries(vecs, 24, seed=0)
        small = recall(s0.submit(gid, "knn", q), knn_brute_force(vecs, q, 10))
    print(f"knn reference corpus (tests/test_search.py:164, 240 x 8): "
          f"recall@10 {small:.4f}")
    if small < KNN_RECALL:
        raise AssertionError(f"knn recall@10 {small} on the reference "
                             f"corpus")

    built = corpora["clustered"].result()
    vecs, g = built["vectors"], built["graph"]
    print(f"knn corpus: {len(vecs)} x {vecs.shape[1]} clustered vectors, "
          f"NSW k {KNN_K}, {g.num_edges} edges, built on the host in "
          f"{built['seconds']:.1f} s, host oracles in "
          f"{built['oracle_seconds']:.1f} s (beside the graph phases)")
    session = EngineSession(device=dev)
    gid = session.register(g, "knn-sift-cut", vectors=vecs)
    entry = session.registry.get(gid)
    p = entry.search_params
    print(f"knn registered: bucket {entry.bucket_shape}, {p}")

    def launch_wall():
        return session.metrics().histogram(
            "engine_launch_wall_seconds", "device wall per launch",
            kernel="knn", backend="single").sum

    queries = knn_queries(vecs, KNN_QUERIES, seed=0)
    K.knn_iterations = 0
    wall0 = launch_wall()
    t0 = time.perf_counter()
    ids = session.submit(gid, "knn", queries)
    seconds = time.perf_counter() - t0
    wall = launch_wall() - wall0
    iterations = K.knn_iterations
    lanes = 1 << (KNN_QUERIES - 1).bit_length()
    mask_bytes = lanes * entry.bucket_shape[0]
    served_visits = entry.visits_total
    rows = float(np.mean([np.array_equal(a, b) for a, b in
                          zip(ids, built["host_ids"])]))
    got_recall = recall(ids, built["brute"])
    host_recall = recall(built["host_ids"], built["brute"])
    print(f"knn: {KNN_QUERIES} queries, launch wall {wall:.4f} s "
          f"(submit {seconds:.4f} s), {iterations} loop iterations, "
          f"visited masks {mask_bytes} bytes ({lanes} x "
          f"{entry.bucket_shape[0]} bool) [{card}]")
    print(f"knn: {100 * rows:.2f}% of the rows equal the host oracle's; "
          f"visits {served_visits} (host {built['host_visits']}); "
          f"recall@{p.k_return} {got_recall:.4f} (host oracle "
          f"{host_recall:.4f})")
    # float32 distances summed in another order may swap near-tied
    # candidates: most rows, not all, must equal the host's
    if rows < KNN_AGREE or got_recall < host_recall - 0.01:
        raise AssertionError(f"knn: {rows} of the rows equal the host "
                             f"oracle's, recall {got_recall} against its "
                             f"{host_recall}")
    if not 0 < iterations <= p.max_steps:
        raise AssertionError(f"knn ran {iterations} iterations")

    # a repeat, past the result cache: the same bits
    handle = entry.handle
    first, visits = session.executor.single.run(handle, "knn", queries)
    again, visits2 = session.executor.single.run(handle, "knn", queries)
    if not (torch.equal(first, again) and torch.equal(visits, visits2)):
        raise AssertionError("knn: two runs differ")
    if first.device.type != dev.type:
        raise AssertionError(f"knn ran on {first.device}")
    # the identity layout, then visit-sorted, then patched
    tiers = []
    for _ in range(2):
        r = session.refresh_hotness(gid)
        tiers.append((r["tier"], r["scheme"]))
        if not np.array_equal(session.submit(gid, "knn", queries), ids):
            raise AssertionError(f"knn ids changed with the layout {r}")
    if tiers != [("full", "visitsort"), ("patch", "visitsort")]:
        raise AssertionError(f"knn refresh_hotness tiers {tiers}")
    print(f"knn: ids bit-identical across the identity layout and "
          f"refresh_hotness {tiers}, and on a repeat")

    walls = {}
    for n, seed in ((1, 1), (64, 2), (KNN_QUERIES, 3)):
        q = knn_queries(vecs, n, seed)
        w0 = launch_wall()
        session.submit(gid, "knn", q)
        walls[n] = launch_wall() - w0
    print(f"knn batch launch wall by batch size: "
          + ", ".join(f"{n}: {w:.4f} s" for n, w in walls.items())
          + f" [{card}]")
    session.close()

    built = corpora["integer"].result()
    ivecs, ig = built["vectors"], built["graph"]
    iq = np.random.default_rng(SEED + 1).integers(0, 12, (64, 16)).astype(
        np.float32)
    with EngineSession(device=dev) as s2:
        gid = s2.register(ig, "knn-int", vectors=ivecs)
        got = s2.submit(gid, "knn", iq)
        served_visits = s2.registry.get(gid).visits_total
    start = medoid_entry(ivecs)
    host_visits = 0
    for q, row in zip(iq, got):
        want, visited = knn_search_baseline(ig, ivecs, q, start)
        host_visits += int(visited.sum())
        if row.tolist() != want.tolist():
            raise AssertionError(f"knn ids {row} != host oracle {want}")
    if served_visits != host_visits:
        raise AssertionError(f"knn visits {served_visits} != host "
                             f"{host_visits}")
    print(f"knn integer corpus: {len(ivecs)} x {ivecs.shape[1]}, NSW k 8, "
          f"{len(iq)} queries: every id equals the host oracle's, visits "
          f"{served_visits} equal the host's")
    return {"launch_wall_s": wall, "iterations": iterations,
            "mask_bytes": mask_bytes, "recall": got_recall, "walls": walls}


# ------------------------------------------------------------ the LM slice
def flash_check(name, q, k, v, window=0, rows=None, tol=None,
                causal=True, prefix=0) -> float:
    """Kernel vs plain version on the same card tensors; returns max |err|.

    k and v may hold BH / group rows (grouped-query attention); then the
    kernel must also give the bits it gives on k and v repeated per query
    row. ``rows`` limits the comparison to those (b·h) rows of the
    kernel's output, each against the plain version on that row and its
    kv row alone. ``tol`` defaults to the reference test's tolerance for
    q's dtype. ``causal``, ``prefix`` and ``window`` give the mask."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.flash_attn.ref import attention_ref
    mask = dict(window=window, causal=causal, prefix=prefix)
    group = fa.kv_group(q, k, v)
    got = fa.flash_attention(q, k, v, **mask)
    again = fa.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"flash_attention[{name}]: two runs differ")
    if group > 1 and not torch.equal(got, fa.flash_attention(
            q, k.repeat_interleave(group, 0), v.repeat_interleave(group, 0),
            **mask)):
        raise AssertionError(f"flash_attention[{name}]: grouped kv differs "
                             f"from the same kv repeated per query row")
    tol = tol or FLASH_TOL[str(q.dtype).removeprefix("torch.")]
    err = 0.0
    for sl, kv in ([(slice(None), slice(None))] if rows is None
                   else [(slice(i, i + 1), slice(i // group, i // group + 1))
                         for i in rows]):
        want = attention_ref(q[sl], k[kv], v[kv], **mask).float()
        torch.testing.assert_close(got[sl].float(), want, **tol)
        err = max(err, float((got[sl].float() - want).abs().max()))
        del want
    print(f"flash_attention[{name}]: shape={tuple(q.shape)} kv rows="
          f"{k.shape[0]} dtype={q.dtype} "
          f"variant={fa.variant(q.dtype, q.shape[2])} "
          f"mask={fa.mask_kind(causal, prefix)} "
          f"prefix={prefix if causal else 0} "
          f"window={window if causal else 0} max_abs_err={err:.3e}")
    return err


def flash_boundary_check(q, k, v, prefix: int = 300) -> None:
    """The mask's edges, one key at a time, on (BH, S, d) q, k, v with S
    and ``prefix`` inside a tile of every variant (S 600, prefix 300).
    Causal with the prefix: a change to key ``prefix``, the first past it,
    leaves rows below it bit for bit and moves row ``prefix``; a change to
    key ``prefix - 1`` moves row 0. Non-causal: a change to the last key
    (in the ragged tile) moves row 0."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    s = q.shape[1]

    def bumped(j):
        k2, v2 = k.clone(), v.clone()
        k2[:, j], v2[:, j] = k2[:, j] + 4.0, v2[:, j] - 4.0
        return k2, v2

    base = fa.flash_attention(q, k, v, prefix=prefix)
    past = fa.flash_attention(q, *bumped(prefix), prefix=prefix)
    last = fa.flash_attention(q, *bumped(prefix - 1), prefix=prefix)
    every = fa.flash_attention(q, k, v, causal=False)
    end = fa.flash_attention(q, *bumped(s - 1), causal=False)
    torch.cuda.synchronize()
    name = (f"flash_attention[boundaries, {q.dtype}, d {q.shape[2]}, S {s}, "
            f"prefix {prefix}]")
    if not torch.equal(base[:, :prefix], past[:, :prefix]):
        raise AssertionError(f"{name}: key {prefix} moved a row below the "
                             f"prefix")
    for rows, a, b, what in ((slice(prefix, prefix + 1), base, past,
                              f"key {prefix} left row {prefix}"),
                             (slice(0, 1), base, last,
                              f"key {prefix - 1} left row 0"),
                             (slice(0, 1), every, end,
                              f"key {s - 1} left row 0 (non-causal)")):
        if torch.equal(a[:, rows], b[:, rows]):
            raise AssertionError(f"{name}: {what} unchanged")
    print(f"{name}: rows below the prefix keep their bits when key {prefix} "
          f"changes; rows {prefix} and 0 see keys {prefix} and "
          f"{prefix - 1}; non-causal row 0 sees key {s - 1}")


def flash_lse_check(q, k, v) -> None:
    """`flash_attention_lse` on bf16 q, k, v under the causal, prefix-LM
    (prefix 40) and bidirectional masks: its output equal, bit for bit, to
    `flash_attention`'s, its row log-sum-exp to `attention_lse_ref`'s at
    rtol/atol 1e-4."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.flash_attn.ref import attention_lse_ref
    err = 0.0
    for mask in (dict(), dict(prefix=40), dict(causal=False)):
        o, lse = fa.flash_attention_lse(q, k, v, **mask)
        if not torch.equal(o, fa.flash_attention(q, k, v, **mask)):
            raise AssertionError(f"flash_attention_lse[d {q.shape[2]}, "
                                 f"{mask}]: output bits differ")
        want = attention_lse_ref(q, k, **mask)
        torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-4)
        err = max(err, float((lse - want).abs().max()))
    print(f"flash_attention_lse[{tuple(q.shape)} over {k.shape[0]} kv rows]: "
          f"output bits equal, lse max_abs_err={err:.3e} (causal, prefix "
          f"40, bidirectional)")


def hot_check(name, ids, table, hot: int, verbose: bool = True) -> float:
    """Kernel vs plain version, exact; the hot/cold lookup equals
    ``table[ids]``. Returns max |err| (0 when exact)."""
    import torch
    from repro_torch.kernels.hot_embed import hot_embed as he
    from repro_torch.kernels.hot_embed.ops import hot_cold_lookup
    from repro_torch.kernels.hot_embed.ref import hot_gather_ref
    got = he.hot_gather(ids, table[:hot])
    again = he.hot_gather(ids, table[:hot])
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"hot_gather[{name}]: two runs differ")
    want = hot_gather_ref(ids, table[:hot])
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"hot_gather[{name}]: differs from the plain "
                             f"version, max |err| {err}")
    if not torch.equal(hot_cold_lookup(ids, table, hot), table[ids.long()]):
        raise AssertionError(f"hot_cold_lookup[{name}] != table[ids]")
    if verbose:
        print(f"hot_gather[{name}]: ids={ids.numel()} "
              f"hot ids={int((ids < hot).sum())} hot={hot} "
              f"vocab={table.shape[0]} D={table.shape[1]} exact")
    return err


def lm_kernel_cases(dev) -> tuple[float, float]:
    """Phase 6: the reference tests' cases of both LM kernels, on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    flash_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for bh, s, d in ((2, 256, 64), (1, 512, 128), (3, 256, 32),
                         (2, 300, 64)):
            for window in (0, 128):
                q, k, v = (normal((bh, s, d), dtype) for _ in range(3))
                flash_err = max(flash_err, flash_check(
                    f"{bh}x{s}x{d}", q, k, v, window))
        from repro_torch.kernels.flash_attn.flash_attn import flash_attention
        q, k, v = (normal((1, 300, 32), dtype) for _ in range(3))
        o1 = flash_attention(q, k, v)
        k[:, 200:], v[:, 200:] = 99.0, -99.0     # corrupt the future
        if not torch.equal(o1[:, :200], flash_attention(q, k, v)[:, :200]):
            raise AssertionError("flash_attention: future keys moved the "
                                 "output")
        print(f"flash_attention[causality, {dtype}]: rows before the "
              f"corrupted keys unchanged")

    # grouped-query attention in every variant: 8 query rows over 8 /
    # group kv rows
    for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 128),
                     (torch.bfloat16, 16), (torch.bfloat16, 32),
                     (torch.float32, 64)):
        for group in (2, 4, 8):
            for s in (256, 300, 4096):
                for window in (0, 128):
                    q = normal((8, s, d), dtype)
                    k, v = (normal((8 // group, s, d), dtype)
                            for _ in range(2))
                    flash_err = max(flash_err, flash_check(
                        f"gqa group {group}, 8x{s}x{d}", q, k, v, window))
    # multi-head calls keep the bits of the kernel before it took
    # grouped-query attention (tests/test_torch_cuda.py::MHA_DIGESTS)
    from repro_torch.kernels.flash_attn import flash_attn as fa
    tc = card_tests()
    for case in tc.DIGEST_CASES:
        dtype, d, s, window = case
        got = tc.flash_digest(fa.flash_attention, *case, dev)
        if got != tc.MHA_DIGESTS[(d, s, window, str(dtype))]:
            raise AssertionError(f"flash_attention[{case}]: multi-head bits "
                                 f"changed")
    print(f"flash_attention: multi-head bits unchanged in "
          f"{len(tc.DIGEST_CASES)} cases")
    # the served configs' groups past 8 and mixtral's window of 4,096
    # (tests/test_torch_cuda.py::SERVED_FLASH_CASES): chatglm3-6b's group
    # of 16, starcoder2-7b's of 9, and a window that cuts every row past
    # 4,096 at S 8,192 and 8,192 + 77; one bf16 unit of the output
    for case in tc.SERVED_FLASH_CASES:
        h, kv, s, window = case
        flash_err = max(flash_err, flash_check(
            f"served group {h // kv}, {h}x{s}x128 over {kv} kv rows",
            *tc.served_flash_inputs(case, dev), window,
            tol=FLASH_MASK_TOL))
    # causal, sliding-window, prefix-LM (a prefix shorter and longer than
    # a tile, and than S) and bidirectional masks in every variant and at
    # head dims 80 and 256; S no multiple of any tile; then grouped kv
    # (8 query rows on 1 kv row) with a prefix
    bf16, f32 = torch.bfloat16, torch.float32
    variants = ((bf16, 64), (bf16, 80), (bf16, 128), (bf16, 16), (bf16, 32),
                (bf16, 256), (f32, 32), (f32, 128))
    for dtype, d in variants:
        tol = FLASH_MASK_TOL if dtype == bf16 else None
        for s in (300, 1000):
            for mask in (dict(), dict(window=128), dict(prefix=256),
                         dict(prefix=700), dict(causal=False)):
                q, k, v = (normal((2, s, d), dtype) for _ in range(3))
                flash_err = max(flash_err, flash_check(
                    f"masks 2x{s}x{d}", q, k, v, tol=tol, **mask))
        flash_boundary_check(*(normal((2, 600, d), dtype) for _ in range(3)))
    for dtype, d in ((bf16, 256), (bf16, 128), (bf16, 80), (f32, 64)):
        tol = FLASH_MASK_TOL if dtype == bf16 else None
        for s in (300, 4096):
            q = normal((8, s, d), dtype)
            k, v = (normal((1, s, d), dtype) for _ in range(2))
            flash_err = max(flash_err, flash_check(
                f"gqa group 8, prefix 256, 8x{s}x{d}", q, k, v, tol=tol,
                prefix=256))
    # the Hopper kernel's kLse instantiations: the bits of the forward
    # without it, and the plain version's log-sum-exp to 1e-4
    for d in (64, 80, 128, 256):
        q = normal((8, 300, d), bf16)
        k, v = (normal((1, 300, d), bf16) for _ in range(2))
        flash_lse_check(q, k, v)

    hot_err = 0.0
    # the reference cases, then chatglm3-6b's and starcoder2-7b's widths
    for vocab, hot, n, d in ((1000, 128, 400, 32), (4096, 512, 512, 32),
                             (600, 600, 14, 32), (8192, 1024, 512, 4096),
                             (8192, 1024, 512, 4608)):
        table = normal((vocab, d), torch.float32)
        ids = torch.from_numpy(rng.integers(0, vocab, n).astype(
            np.int32)).to(dev)
        hot_err = max(hot_err, hot_check(f"{vocab}/{hot}", ids, table, hot))
    table = normal((64, 8), torch.float32)
    hot_check("all_hot", torch.arange(16, dtype=torch.int32, device=dev),
              table, 32)
    hot_check("all_cold", torch.arange(32, 64, dtype=torch.int32,
                                       device=dev), table, 32)
    hot_check("hot_is_vocab", torch.tensor([0, 63, 5, 63], dtype=torch.int32,
                                           device=dev), table, 64)
    return flash_err, hot_err


def card_tests():
    """tests/test_torch_cuda.py as a module (for its digests of the
    multi-head flash kernel)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "test_torch_cuda", ROOT / "tests" / "test_torch_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def token_source(cfg, seq_len: int, quiet: bool = False):
    """The repo's token pipeline at ``seq_len``: the Zipf-community corpus
    with its defaults (seed 1234), mapped through the vocab LOrder built
    from its first batch, as the reference's
    ``launch/train.build_vocab_reorder`` builds it. Returns
    ``tokens(step, n)``, the first ``n`` ids of batch ``step`` as a
    (1, n) CPU tensor; steps from 1 on were not in the LOrder's sample.
    ``quiet`` prints nothing (a pool worker's)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import (DataConfig, ZipfCommunityCorpus,
                                           corpus_sample)
    from repro_torch.locality.vocab import hot_coverage, vocab_permutation
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                    global_batch=1)
    t0 = time.perf_counter()
    sample = corpus_sample(dc, num_batches=1)
    vr = vocab_permutation(sample, cfg.vocab_size,
                           hot_fraction=cfg.hot_vocab_fraction)
    corpus = ZipfCommunityCorpus(dc)
    if not quiet:
        print(f"vocab LOrder: hot slab {vr.hot_size} rows, built from "
              f"{sample.size} corpus tokens in "
              f"{time.perf_counter() - t0:.1f} s; it covers "
              f"{100 * hot_coverage(corpus.batch(1), vr):.1f}% of the "
              f"held-out batch 1")

    def tokens(step: int, n: int):
        return torch.from_numpy(vr.map_tokens(
            corpus.batch(step)[:, :n]).astype(np.int32))
    return tokens


def lm_batch(cfg, tokens, step: int, seq_len: int) -> dict:
    """The prefill batch of ``seq_len`` positions that
    ``configs/shapes.input_specs`` defines for ``cfg``, at batch 1, on the
    CPU: ``tokens`` from the token source (its batch ``step``); a
    prefix-LM's prefix of embeddings and an encoder's frames from N(0, 1)
    on a ``torch.Generator`` seeded with SEED + step, in their spec's
    dtype."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec, input_specs
    spec = ShapeSpec(f"prefill_{seq_len}", seq_len, 1, "prefill")
    gen = torch.Generator().manual_seed(SEED + step)
    batch = {}
    for name, t in input_specs(cfg, spec).items():
        batch[name] = (tokens(step, t.shape[1]) if name == "tokens" else
                       torch.randn(t.shape, generator=gen).to(t.dtype))
    return batch


def on(dev, batch: dict) -> dict:
    return {name: t.to(dev) for name, t in batch.items()}


@contextlib.contextmanager
def token_stream(model):
    """``model`` with a prefix-LM's prefix cut to 0, as
    tests/test_models.py::test_decode_matches_forward runs paligemma: a
    decode step takes tokens only, so its forward must too."""
    import dataclasses
    cfg = model.cfg
    mods = [model, *model.layers]
    for m in mods:
        m.cfg = dataclasses.replace(cfg, prefix_tokens=0)
    try:
        yield model
    finally:
        for m in mods:
            m.cfg = cfg


def first_attention_heads(model, batch):
    """The (B·H, S, dh) q and (B·KV, S, dh) k and v that the prefill's
    first attention hands the flash kernel, as `apply_attention` makes
    them, and where they come from: layer 0's, or a hybrid's shared block
    at its first application (the trunk run up to that layer, then the
    block's norm1). None for a trunk without attention (rwkv)."""
    import torch
    from repro_torch.models.layers import _dense, apply_norm, apply_rope
    from repro_torch.models.transformer import embed_inputs
    cfg = model.cfg
    if not cfg.attn_positions:
        return None
    first = cfg.attn_positions[0]
    x = embed_inputs(model, batch)
    if model.shared_attn is None:
        blk, where = model.layers[0], "layer0"
    else:
        for layer in model.layers[:first]:
            x, _ = layer(x)
        blk, where = model.shared_attn, f"shared block at layer {first}"
    x = apply_norm(blk.norm1, x, cfg)
    b, s = x.shape[:2]
    dh = cfg.head_dim
    pos = torch.arange(s, dtype=torch.int32, device=x.device)

    def heads(w, n, rope=True):
        t = _dense(x, blk.attn[f"w{w}"], blk.attn.get(f"b{w}")).reshape(
            b, s, n, dh)
        if rope:
            t = apply_rope(t, pos, cfg)
        return t.transpose(1, 2).reshape(b * n, s, dh).contiguous()
    kv = cfg.num_kv_heads
    return (heads("q", cfg.num_heads), heads("k", kv),
            heads("v", kv, rope=False), where)


def lm_launches() -> dict:
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.hot_embed import hot_embed as he
    from repro_torch.kernels.moe_gmm import moe_gmm as gm
    return {"flash_attn": fa.launches,
            "flash_attn_wgmma": fa.launches_by_variant["wgmma"],
            "flash_attn_mma_sync": fa.launches_by_variant["mma_sync"],
            "flash_attn_gqa": fa.launches_grouped,
            "flash_attn_windowed": fa.launches_windowed,
            "flash_attn_prefix": fa.launches_by_mask["prefix"],
            "flash_attn_non_causal": fa.launches_by_mask["non_causal"],
            "hot_embed": he.launches, "moe_gmm": gm.launches,
            "moe_gmm_wgmma": gm.launches_by_variant["wgmma"],
            "moe_gmm_splitk": gm.launches_by_variant["splitk"],
            "moe_gmm_tgmm": gm.launches_by_variant["tgmm"]}


def reset_lm_launches() -> None:
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.hot_embed import hot_embed as he
    from repro_torch.kernels.moe_gmm import moe_gmm as gm
    fa.launches = fa.launches_grouped = fa.launches_windowed = 0
    he.launches = gm.launches = 0
    fa.launches_by_variant = dict.fromkeys(fa.VARIANTS, 0)
    fa.launches_by_mask = dict.fromkeys(fa.MASKS, 0)
    gm.launches_by_variant = dict.fromkeys(gm.VARIANTS, 0)


def gmm_launches(cfg, tokens: int, calls: int, backwards: int = 0) -> dict:
    """The ``moe_gmm`` launches of ``calls`` forwards or decode steps of
    ``tokens`` tokens each, ``backwards`` of them differentiated: gate, up
    and down in every MoE layer, all through the variant that
    `moe_gmm.variant` picks for tokens x top-k rows (moonshot: ``wgmma``
    at the prefill and a training microbatch, ``splitk`` at a decode
    step), and in a backward dX of each product through ``wgmma`` (the
    stack read transposed, at any row count) and its dW through
    ``tgmm``."""
    from repro_torch.kernels.moe_gmm import moe_gmm as gm
    out = {"moe_gmm": 0, "moe_gmm_wgmma": 0, "moe_gmm_splitk": 0,
           "moe_gmm_tgmm": 0}
    if cfg.is_moe:
        fwd, bwd = (3 * cfg.num_layers * c for c in (calls, backwards))
        v = gm.variant(tokens * cfg.experts_per_token, cfg.num_experts,
                       cfg.d_model, cfg.d_ff)
        out.update({"moe_gmm": fwd + bwd, "moe_gmm_tgmm": bwd})
        out[f"moe_gmm_{v}"] += fwd
        out["moe_gmm_wgmma"] += bwd
    return out


def flash_mask(cfg) -> dict:
    """The flash kernel's mask arguments for ``cfg``'s attention."""
    return dict(window=cfg.window, causal=cfg.causal,
                prefix=cfg.prefix_tokens)


def flash_launches(cfg, calls: int) -> dict:
    """The flash launches of ``calls`` forwards: one an attention layer
    (a hybrid's: one an application of its shared block; none for rwkv),
    all through the variant of ``cfg``'s head dim, grouped and masked as
    its attention is (a sliding window counts apart as well)."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    n = len(cfg.attn_positions) * calls
    v = fa.variant(torch.bfloat16, cfg.head_dim)
    kind = fa.mask_kind(cfg.causal, cfg.prefix_tokens)
    return {"flash_attn": n,
            "flash_attn_wgmma": n if v == "wgmma" else 0,
            "flash_attn_mma_sync": n if v == "mma_sync" else 0,
            "flash_attn_gqa": n if cfg.num_kv_heads < cfg.num_heads else 0,
            "flash_attn_windowed": n if cfg.causal and cfg.window > 0 else 0,
            "flash_attn_prefix": n if kind == "prefix" else 0,
            "flash_attn_non_causal": n if kind == "non_causal" else 0}


def prefill(dev, model, batch) -> dict:
    """Phase 7: the prefill forward at full width, on ``batch``
    (`lm_batch`)."""
    import torch
    from repro_torch.models.layers import hot_vocab_size
    from repro_torch.models.transformer import forward, trunk_kind

    cfg = model.cfg
    batch = on(dev, batch)
    # warm-up (cuBLAS, libs) on the first 256 positions after any prefix
    forward(model, {n: t if n == "prefix" else t[:, :256]
                    for n, t in batch.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_lm_launches()
    t0 = time.perf_counter()
    logits, aux = forward(model, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = lm_launches()
    n_tokens = logits.shape[1]
    tokens = batch.get("tokens")
    expected = {**flash_launches(cfg, 1),
                "hot_embed": 0 if tokens is None else 1,
                **gmm_launches(cfg, n_tokens, 1)}
    if launches != expected:
        raise AssertionError(f"prefill launches {launches}, expected "
                             f"{expected}")
    if tuple(logits.shape) != (1, n_tokens, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    # in slices of 4,096 positions: a whole-tensor isfinite allocates
    # several (S, V) temporaries
    if not all(bool(torch.isfinite(logits[:, i:i + 4096]).all())
               for i in range(0, n_tokens, 4096)):
        raise AssertionError("prefill logits are not all finite")
    if cfg.is_moe and not (bool(torch.isfinite(aux)) and float(aux) > 0):
        raise AssertionError(f"prefill aux loss {float(aux)}")
    inputs = ", ".join(f"{n} {tuple(t.shape)}" for n, t in batch.items())
    print(f"prefill: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"positions=1x{n_tokens} ({inputs}) forward {seconds:.3f} s "
          f"({n_tokens / seconds:.1f} tokens/s), launches {launches}, "
          f"peak {peak:.1f} GiB, logits finite, aux {float(aux):.4f}")
    del logits
    heads = first_attention_heads(model, batch)
    out = {"launches": launches, "seconds": seconds, "err": 0.0,
           "hot_err": 0.0, "q": None, "ids": None}
    if heads is None:
        print(f"flash_attention[{cfg.name}]: no flash check: the "
              f"{trunk_kind(cfg)} trunk has no attention")
    else:
        q, k, v, where = heads
        mask = flash_mask(cfg)
        err = flash_check(f"{where} served, rows 0-1", q, k, v, rows=(0, 1),
                          tol=FLASH_SERVED_TOL, **mask)
        # a window cuts every row past it at twice its length
        s4 = 2 * cfg.window if cfg.window else 4096
        err = max(err, flash_check(
            f"{where} all heads",
            *(t[:, :s4].contiguous() for t in (q, k, v)),
            tol=FLASH_SERVED_TOL, **mask))
        out.update(err=err, q=q, k=k, v=v)
    if tokens is not None:
        out["ids"] = tokens.reshape(-1)
        out["hot_err"] = hot_check("prefill served", out["ids"],
                                   model.embed["table"], hot_vocab_size(cfg))
    if cfg.is_moe:
        out["moe"] = moe_layer0(model, batch)
    return out


def gmm_check(name, x, w, offs, verbose: bool = True) -> float:
    """Kernel vs plain version on the same card tensors, for every kernel
    that takes the operands (bf16: both variants, each forced through
    ``variant=``; float32: ``simt``): the float32 result at GMM_TOL (bf16
    products are exact in float32; only the order of the sums differs),
    the bf16 result equal to the variant's float32 one rounded once, rows
    at or past ``offs[E]`` zero, and a repeat giving the same bits. The
    two variants' bits may differ from each other. Returns max |err| of
    the float32 results."""
    import torch
    from repro_torch.kernels.moe_gmm import moe_gmm as gm
    from repro_torch.kernels.moe_gmm.ref import gmm_grouped_ref
    want = gmm_grouped_ref(x, w, offs)
    total = min(int(offs[-1]), x.shape[0])
    bf16 = x.dtype == torch.bfloat16
    errs = {}
    for v in ("wgmma", "splitk") if bf16 else ("simt",):
        got = gm.gmm(x, w, offs, variant=v)
        again = gm.gmm(x, w, offs, variant=v)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"moe_gmm[{name}, {v}]: two runs differ")
        del again    # (65,536 x 14,336 float32 at mixtral's prefill: 3.5 GiB)
        torch.testing.assert_close(got, want, **GMM_TOL)
        errs[v] = float((got - want).abs().max()) if got.numel() else 0.0
        if got[total:].any():
            raise AssertionError(f"moe_gmm[{name}, {v}]: rows past the "
                                 f"groups are not zero")
        if bf16:
            half = gm.gmm(x, w, offs, out_dtype=torch.bfloat16, variant=v)
            if not torch.equal(half, got.to(torch.bfloat16)):
                raise AssertionError(f"moe_gmm[{name}, {v}]: the bf16 result "
                                     f"is not the float32 one rounded")
        del got
    if verbose:
        sizes = (offs[1:] - offs[:-1]).tolist()
        e, k, n = w.shape
        print(f"moe_gmm[{name}]: M={x.shape[0]} K={k} N={n} E={e} "
              f"rows={total} empty groups={sizes.count(0)} dtype={x.dtype} "
              f"rule picks {gm.variant(x.shape[0], e, k, n) if bf16 else 'simt'}"
              f"; max_abs_err " + ", ".join(f"{v} {err:.3e}"
                                           for v, err in errs.items()))
    return max(errs.values())


def gmm_kernel_cases(dev) -> float:
    """Phase 12: ``moe_gmm`` against its plain version on the card: the
    reference test's float32 cases (tests/test_kernels.py:106-138) through
    ``grouped_matmul``, then bf16 at the smoke and moonshot's served widths
    and at mixtral-8x7b's (8 experts, K 4,096 and N 14,336 and back, and a
    decode step's 8 rows), with empty groups, one group holding every
    row, rows past the groups' total, and M not a multiple of 128."""
    import numpy as np
    import torch
    from repro_torch.kernels.moe_gmm import moe_gmm as gm
    from repro_torch.kernels.moe_gmm.ops import grouped_matmul
    from repro_torch.kernels.moe_gmm.ref import gmm_ref
    rng = np.random.default_rng(SEED)

    def normal(shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dev, dtype)

    err = 0.0
    for gs, k, n in (([128, 128, 128, 128], 128, 256),
                     ([100, 30, 0, 128], 128, 256), ([0, 0, 5, 1], 128, 256),
                     ([512, 0, 0, 0], 128, 256), ([128, 128], 384, 128)):
        _, te, total = gm.pad_groups(np.array(gs))
        x, w = normal((total, k)), normal((len(gs), k, n), 0.1)
        te = torch.from_numpy(te).to(dev)
        got = grouped_matmul(x, w, te)
        again = grouped_matmul(x, w, te)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"moe_gmm[{gs}]: two runs differ")
        want = gmm_ref(x, w, te.repeat_interleave(gm.TILE_M))
        torch.testing.assert_close(got, want, **GMM_TOL)
        err = max(err, float((got - want).abs().max()))
        print(f"moe_gmm[reference {gs}, K={k}, N={n}]: float32 "
              f"max_abs_err={float((got - want).abs().max()):.3e}")

    tc = card_tests()
    cases = [(case, m, k, n, e)
             for m, k, n, e in ((40, 64, 128, 4), (40, 128, 64, 4),
                                (1000, 2048, 1408, 64), (1000, 1408, 2048, 64),
                                (333, 2048, 1408, 64), (24, 2048, 1408, 64),
                                (228, 136, 200, 3))
             for case in ("skewed", "one_group", "short")]
    # then mixtral-8x7b's (tests/test_torch_cuda.py::MIXTRAL_GMM_CASES);
    # operands drawn on the card (its stacks hold 4.7e8 weights), once for
    # each run of cases at one shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = None
    for case, m, k, n, e in cases + tc.MIXTRAL_GMM_CASES:
        if shape != (m, k, n, e):
            shape = (m, k, n, e)
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            w = (torch.randn((e, k, n), generator=gen, device=dev)
                 * k ** -0.5).to(torch.bfloat16)
        sizes = tc._variant_sizes(rng, case, m, e)
        offs = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(sizes)]).astype(np.int32)).to(dev)
        err = max(err, gmm_check(f"{case}", x, w, offs))
    return err


def moe_layer0(model, batch) -> dict:
    """Layer 0's MoE on the prefill: its real expert-sorted rows, held to
    the plain version through the gate and the down products, and the
    routing's group sizes and ``dispatch_stats``. Returns the rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.locality.moe import dispatch_stats
    from repro_torch.models.layers import apply_attention, apply_norm
    from repro_torch.models.moe import _route
    from repro_torch.models.transformer import embed_inputs
    cfg, blk = model.cfg, model.layers[0]
    bf16 = torch.bfloat16
    x = embed_inputs(model, batch)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    h, _ = apply_attention(blk.attn, apply_norm(blk.norm1, x, cfg), cfg, pos)
    y = apply_norm(blk.norm2, x + h * cfg.residual_scale, cfg).reshape(
        -1, cfg.d_model)
    experts, _, _ = _route(blk.ffn, y, cfg)
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xs = y[order // cfg.experts_per_token].contiguous()
    sizes = torch.bincount(flat, minlength=cfg.num_experts)
    offs = torch.zeros(cfg.num_experts + 1, dtype=torch.int32,
                       device=xs.device)
    offs[1:] = sizes.cumsum(0)
    w_gate, w_up, w_down = (blk.ffn[n].to(bf16)
                            for n in ("w_gate", "w_up", "w_down"))
    err = gmm_check("layer0 served gate", xs, w_gate, offs)
    from repro_torch.kernels.moe_gmm.moe_gmm import gmm
    act = (F.silu(gmm(xs, w_gate, offs, out_dtype=bf16))
           * gmm(xs, w_up, offs, out_dtype=bf16)).to(bf16)
    err = max(err, gmm_check("layer0 served down", act, w_down, offs))
    counts = sizes.tolist()
    print(f"layer0 routing: {flat.numel()} assignments over "
          f"{cfg.num_experts} experts, group sizes min {min(counts)} max "
          f"{max(counts)}, {counts.count(0)} empty")
    stats = dispatch_stats(experts.cpu().numpy(), cfg.num_experts,
                           d_model=cfg.d_model, d_ff=cfg.d_ff)
    print(f"layer0 dispatch_stats: {json.dumps(stats)}")
    return {"xs": xs, "act": act, "offs": offs, "y": y,
            "experts": experts, "err": err}


def bf16_unit(x):
    """The spacing of bfloat16 values at |x| (8 bits of significand)."""
    import torch
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def hold_logits(name, got, want, held: bool = True) -> None:
    """``got`` against ``want`` ((1, n, V) float32, one device) at
    DECODE_TOL with argmax agreement > 0.95
    (tests/test_models.py::test_decode_matches_forward), the one standard
    for every config.

    A position agrees where ``got``'s top token is ``want``'s top token or
    ties with it to within one bf16 unit of ``want``'s top logit. The
    logits are bf16, as in the reference: two runs that round differently
    order two logits one unit apart either way, and a random-weight model
    has such near-ties among its 163,840 logits at a few positions in a
    hundred. The spread of ``want`` is printed beside the largest
    difference: the two scale together (moonshot's logits have a scale of
    1, minicpm's of 1/9). With ``held`` False it only prints."""
    import torch
    same = want.argmax(-1) == got.argmax(-1)
    best = want.amax(-1)
    picked = want.gather(-1, got.argmax(-1, keepdim=True))[..., 0]
    agree = float((best - picked <= bf16_unit(best)).float().mean())
    print(f"{name}: {got.shape[1]} tokens, max_abs_diff="
          f"{float((got - want).abs().max()):.4f} (logits' std "
          f"{float(want.std()):.4f}), argmax agreement {agree:.4f} "
          f"({float(same.float().mean()):.4f} for the same token; where "
          f"not, want's top logit leads got's pick by "
          f"{[round(float(v), 5) for v in (best - picked)[~same]][:40]})")
    if not held:
        return
    torch.testing.assert_close(got, want, **DECODE_TOL)
    if agree <= 0.95:
        raise AssertionError(f"{name}: argmax agreement {agree}")


def routing_check(name, want_tape, got_experts, got, want) -> None:
    """Where a free-running run's expert choices (``got_experts``, (layers,
    n, k)) part from the reference run's (``want_tape``).

    A flip at layer l0, position p0 moves every later layer's input at p0
    and, through attention, at every later position, so the flips there
    follow from it; the others (roots) are printed with the reference
    run's router margins. Rounding grows with depth in a random-weight
    model, so the margins that it can cross do too; at the first layer
    the two runs' inputs differ by one attention's rounding, and every
    flip there must lie below ROUTE_TIE (the reference's own forward and
    decode part at margins near 1e-4, ``tests/moe_routing_witness.py``;
    a wrong router parts at any margin)."""
    import torch
    margins = torch.stack(want_tape.margins)                 # (layers, n)
    differ = (torch.stack(want_tape.experts) != got_experts).any(-1)
    upto = differ.int().cumsum(1).clamp(max=1)       # a flip at p' <= p
    below = (upto.cumsum(0) - upto) > 0              # ... at a layer < l
    roots = [(int(layer), f"{float(margins[layer, p]):.2e}")
             for layer, p in (differ & ~below).nonzero()]
    print(f"{name}, free routing: max_abs_diff="
          f"{float((got - want).abs().max()):.4f}, argmax agreement "
          f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.4f}; "
          f"routing parts at {int(differ.any(0).sum())} of {differ.shape[1]}"
          f" positions ({int(differ.sum())} of {differ.numel()} "
          f"layer-positions); roots at (layer, router margin) "
          f"{roots}"
          f"; the median margin is {float(margins.median()):.2e}")
    first = margins[0][differ[0]]
    if first.numel() and float(first.max()) >= ROUTE_TIE:
        raise AssertionError(f"{name}: routing parts at the first layer at "
                             f"a router margin of {float(first.max())}")


def decode_consistency(dev, model, tokens) -> None:
    """Phase 8: forward (flash kernel) against teacher-forced decode.

    For MoE the free-running decode's routing is held by `routing_check`,
    and the logits by `hold_logits` on a decode that replays the
    forward's expert choices (`models.moe.RouteTape`): a choice parted at
    a near-tie moves a token's output by a whole expert's share and every
    later layer and position with it, in the reference too. A prefix-LM
    runs as a pure token stream (`token_stream`). A recurrent trunk's
    decode is held layer by layer (`layer_forced_decode`)."""
    from repro_torch.models.transformer import trunk_kind
    if trunk_kind(model.cfg) != "attn":
        layer_forced_decode(dev, model, tokens)
        return
    with token_stream(model):
        _decode_consistency(dev, model, tokens)


class BlockTape:
    """Every block call of a model, in call order: `record` keeps each
    call's input and output; `replay` feeds each call the recorded input
    to the same call, through ``pick`` (a slice or a device move), and
    holds its output to the recorded one (``pick``ed too) at DECODE_TOL.

    For the recurrent trunks (rwkv, hybrid) with random weights: they
    amplify a rounding difference layer by layer, in the reference too
    (its own decode parts from its forward beyond the decode standard
    from 6 of rwkv6-3b's layers on, tests/ssm_depth_witness.py), and
    RWKV6's per-head group norm turns a head's output at position 1,
    (r_1·k_0) v_0, into ±v_0 by the sign of r_1·k_0, which two runs that
    round differently can flip where it is near zero. Fed each other's
    inputs, two runs differ by one block's rounding at a time. A step
    calls the blocks in the forward's order (a hybrid's shared block
    before its Mamba block), so a step's n-th call is the forward's
    n-th."""

    def __init__(self, model):
        self.blocks = [b for b in (*model.layers, model.shared_attn)
                       if b is not None]
        self.ins, self.outs = [], []
        self.call, self.worst = 0, (0.0, 0)

    @contextlib.contextmanager
    def _hooks(self, *pairs):
        hooks = [h for b in self.blocks for kind, fn in pairs
                 for h in [getattr(b, kind)(fn)]]
        try:
            yield self
        finally:
            for h in hooks:
                h.remove()

    def record(self):
        def keep(mod, args, out):
            self.ins.append(args[0])
            self.outs.append(out[0])
        return self._hooks(("register_forward_hook", keep))

    def replay(self, pick):
        import torch

        def force(mod, args):
            return (pick(self.ins[self.call]), *args[1:])

        def check(mod, args, out):
            want = pick(self.outs[self.call]).float()
            got = out[0].float().to(want.device)
            torch.testing.assert_close(got, want, **DECODE_TOL)
            self.worst = max(self.worst, (float((got - want).abs().max()),
                                          self.call))
            self.call += 1
        self.call, self.worst = 0, (0.0, 0)
        return self._hooks(("register_forward_pre_hook", force),
                           ("register_forward_hook", check))


def layer_forced_decode(dev, model, tokens) -> None:
    """Phase 8 for the recurrent trunks: the free-running decode at full
    depth is printed, not held; the decode is held on a run whose blocks
    are fed the forward's inputs (`BlockTape`): every block output of
    every step at DECODE_TOL, and the logits by `hold_logits`."""
    import torch
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_cache)
    cfg = model.cfg
    tokens = tokens.to(dev)
    n = tokens.shape[1]
    tape = BlockTape(model)
    with tape.record():
        full = forward(model, {"tokens": tokens})[0].float()
    calls, pos = len(tape.ins), [0]

    def decode(after=lambda i: None):
        cache, steps = init_cache(cfg, 1, n, device=dev), []
        for i in range(n):
            pos[0] = i
            lg, cache = decode_step(model, cache, tokens[:, i:i + 1])
            steps.append(lg[:, 0].float())
            after(i)
        return torch.stack(steps, dim=1)

    hold_logits(f"decode vs forward, free-running over {cfg.num_layers} "
                f"layers (printed, not held)", decode(), full, held=False)
    worst = (0.0, 0, 0)

    def after(i):
        nonlocal worst
        worst = max(worst, (*tape.worst, i))
        tape.call, tape.worst = 0, (0.0, 0)
    with tape.replay(lambda t: t[:, pos[0]:pos[0] + 1]):
        dec = decode(after)
    print(f"decode vs forward, each block fed the forward's input: {calls} "
          f"block calls a step, {n} steps, every block output within "
          f"rtol/atol 0.15; the largest difference {worst[0]:.4f} at call "
          f"{worst[1]}, step {worst[2]}")
    hold_logits("decode vs forward, each block fed the forward's input",
                dec, full)


def _decode_consistency(dev, model, tokens) -> None:
    import torch
    from repro_torch.models.moe import RouteTape
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_cache)
    cfg = model.cfg
    tokens = tokens.to(dev)
    n, layers = tokens.shape[1], cfg.num_layers
    with RouteTape() as fwd:
        full = forward(model, {"tokens": tokens})[0].float()

    def decode(replay=None):
        cache = init_cache(cfg, 1, n, device=dev)
        steps = []
        with RouteTape(replay) as tape:
            for i in range(n):
                lg, cache = decode_step(model, cache, tokens[:, i:i + 1])
                steps.append(lg[:, 0].float())
        return torch.stack(steps, dim=1), tape

    dec, tape = decode()
    name = "decode vs forward"
    if cfg.is_moe:
        # a decode step routes one position through every layer
        by_step = torch.stack(tape.experts).reshape(n, layers, -1)
        routing_check(name, fwd, by_step.transpose(0, 1), dec, full)
        dec, _ = decode([fwd.experts[layer][i:i + 1] for i in range(n)
                         for layer in range(layers)])
        name += ", the forward's routing replayed"
    hold_logits(name, dec, full)


# ------------------------------------- the host's halves, in pool workers
def pool_threads(jobs: int = 1) -> int:
    """The intra-op torch threads each of ``jobs`` pool jobs at work at
    once takes: half the host's cores between them, the rest for the main
    process, whose host-bound decode slows several-fold when the cores
    are oversubscribed (PERF.md §6)."""
    return max(1, (os.cpu_count() or 1) // 2 // jobs)


def draw_weights(cfg, device):
    """`init_params` of ``cfg`` on a CUDA generator seeded with `SEED`, on
    ``device``: the main process draws the card's copy so and a pool
    worker the CPU's, bit for bit the same weights, in a fraction of a
    second where a CPU generator draws about 10^8 weights a second
    (mixtral-8x7b's 2 layers hold 3.2e9). For the CPU each weight moves
    there as soon as it is drawn (the models' draw helper,
    `layers._normal`, wrapped), so that a worker holds no more than one
    weight on the card beside the main process's model, then frees its
    card memory."""
    import torch
    from repro_torch.models import layers, mamba2, moe, rwkv6
    from repro_torch.models.transformer import init_params
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if torch.device(device).type == "cuda":
        return init_params(cfg, gen, device)
    mods, draw = (layers, mamba2, moe, rwkv6), layers._normal

    def drawn_to_host(gen, shape, scale):
        # `layers._normal` with the scale applied in place: one weight's
        # memory on the card at a time (the digest holds the bits)
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32).mul_(scale).to(device)
    for m in mods:
        m._normal = drawn_to_host
    try:
        model = init_params(cfg, gen, "cuda").to(device)
    finally:
        for m in mods:
            m._normal = draw
    torch.cuda.empty_cache()
    return model


def weight_digest(model):
    """The first 16 values of every parameter, on the CPU: equal on the
    card's copy and the CPU's when both were drawn alike."""
    import torch
    return torch.cat([p.detach().flatten()[:16].float().cpu()
                      for p in model.parameters()])


def host_forward(cfg, batch: dict, threads: int, path: str) -> str:
    """Phase 9's CPU half, in a pool worker, submitted as the config's
    phases start: ``cfg`` cut to 2 layers (a hybrid keeps its shared block
    on the second, as ``smoke_config`` cuts), `draw_weights` to the CPU,
    and its forward, plain versions, on ``batch`` (`lm_batch` step 3),
    on ``threads`` intra-op threads; recorded: the float32 logits, the
    expert choices and router margins (MoE, `RouteTape`) and every block
    call's input and output (`BlockTape`, for a recurrent trunk). Saves
    them to ``path`` (`spool`) and returns it."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch.train import cut_depth
    from repro_torch.models.moe import RouteTape
    from repro_torch.models.transformer import forward, trunk_kind
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    cut = cut_depth(cfg, 2)
    host = draw_weights(cut, "cpu")
    tape = BlockTape(host)
    t1 = time.perf_counter()
    with RouteTape() as route, tape.record():
        want = forward(host, batch)[0].float()
    out = {"want": want, "digest": weight_digest(host),
           "experts": route.experts if cut.is_moe else [],
           "margins": route.margins if cut.is_moe else [],
           "ins": [], "outs": [], "threads": threads,
           "init_s": t1 - t0, "forward_s": time.perf_counter() - t1}
    if trunk_kind(cut) != "attn":
        out.update(ins=tape.ins, outs=tape.outs)
    return spool(out, path)


def spool(obj, path: str) -> str:
    """``obj`` (dicts and lists of tensors and numbers) saved to ``path``
    (``torch.save``): a worker's result goes to a file in the run's
    temporary directory, not through the pool's pipe, whose unpickling
    holds the main process's interpreter for seconds a gigabyte."""
    import torch
    torch.save(obj, path)
    return path


def grad_cut(arch: str, layers: int):
    """``arch``'s config at full width, cut to ``layers`` layers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    return cut_depth(get_config(arch), layers)


def grad_dtype(arch: str, layers: int) -> str:
    """The compute dtype of ``arch``'s card-against-CPU gradients at
    ``layers`` layers: float32 for an arch of `F32_GRAD_ARCHS` at 2
    layers, whose bf16 gradients there are chaotic, else bfloat16."""
    return ("float32" if arch in F32_GRAD_ARCHS and layers > 1
            else "bfloat16")


def host_grads(arch: str, layers: int, threads: int, path: str) -> str:
    """Phase 14's CPU half of a card-against-CPU gradient check, in a pool
    worker (`GradJobs`): `grad_cut`, `draw_weights` to
    the CPU, one microbatch (`lm_batch` step 1 of 512 positions, the
    token source at 512) through `loss_and_grads` in compute dtype
    `grad_dtype`, remat as the config has it, on ``threads`` intra-op
    threads; for an MoE its expert choices, forward and replay
    (`RouteTape`). Saves the batch, the loss, every leaf's float32
    gradient and the choices to ``path`` (`spool`) and returns it."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.models.moe import RouteTape
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    cfg = grad_cut(arch, layers)
    host = draw_weights(cfg, "cpu")
    batch = lm_batch(cfg, token_source(cfg, 512, quiet=True), 1, 512)
    tape = RouteTape() if cfg.is_moe else None
    t1 = time.perf_counter()
    with compute_dtype(getattr(torch, grad_dtype(arch, layers))):
        loss, grads = loss_and_grads(host, batch, tape)
    return spool({"batch": batch, "loss": loss, "grads": grads,
                  "digest": weight_digest(host),
                  "experts": tape.experts if tape is not None else [],
                  "threads": threads, "init_s": t1 - t0,
                  "grads_s": time.perf_counter() - t1}, path)


class HostPool:
    """The run's process pool as the card-against-CPU checks use it, each
    job's result in a file of ``tmp`` (`spool`), the jobs at work on half
    the host's cores: phase 9's forwards one at a time, phase 14's
    `GRAD_CHECKS` two at a time (`GradJobs`)."""

    def __init__(self, pool, tmp: str):
        self.pool, self.tmp, self.jobs = pool, tmp, []

    def forward(self, cfg, batch: dict):
        """A future of `host_forward`."""
        return self._submit(host_forward, f"forward-{cfg.name}",
                            pool_threads(), cfg, batch)

    def _submit(self, fn, name: str, threads: int, *args):
        job = self.pool.submit(fn, *args, threads,
                               os.path.join(self.tmp, name))
        self.jobs.append(job)
        return job


class GradJobs:
    """Futures of `host_grads` by `GRAD_CHECKS` entry, submitted in that
    order two ahead: the first two at once, the next each time one is
    asked for, so that two run on half the cores while phase 14's card
    work, mostly bound by the card, runs beside them."""

    AHEAD = 2

    def __init__(self, host: HostPool):
        self.host, self.futures = host, {}
        self._submit_upto(self.AHEAD)

    def _submit_upto(self, n: int) -> None:
        for arch, layers in GRAD_CHECKS[:n]:
            if (arch, layers) not in self.futures:
                self.futures[arch, layers] = self.host._submit(
                    host_grads, f"grads-{arch}-{layers}",
                    pool_threads(self.AHEAD), arch, layers)

    def __getitem__(self, key):
        self._submit_upto(GRAD_CHECKS.index(key) + 1 + self.AHEAD)
        return self.futures[key]


def host_result(future, what: str, card):
    """A pool worker's result (`spool`), loaded (memory-mapped; the file is
    unlinked at once) and the seconds the main process waited for it;
    its weights held to ``card``'s (`weight_digest`)."""
    import torch
    t0 = time.perf_counter()
    path = future.result()
    waited = time.perf_counter() - t0
    out = torch.load(path, mmap=True)
    os.unlink(path)
    if not torch.equal(out["digest"], weight_digest(card)):
        raise AssertionError(f"{what}: the pool worker drew other weights "
                             f"than the card's")
    print(f"{what}: the CPU's half from a pool worker ({out['threads']} "
          f"torch thread(s): weights {out['init_s']:.1f} s, then "
          f"{out.get('forward_s', out.get('grads_s')):.1f} s), waited "
          f"{waited:.1f} s for it; the same weights as the card's")
    return out


def same_batch(what: str, got: dict, want: dict) -> None:
    import torch
    if got.keys() != want.keys() or not all(
            torch.equal(got[n], want[n]) for n in want):
        raise AssertionError(f"{what}: the pool worker's batch is not the "
                             f"main process's")


def card_vs_cpu(dev, cfg, batch, host) -> None:
    """Phase 9: the config cut to 2 layers (a hybrid's second one flagged
    for the shared block, as ``smoke_config`` cuts), the same weights on
    both, the same ``batch`` (`lm_batch`); the CPU's half is ``host``, a
    future of `host_forward` from the pool (the card's copy drawn alike,
    `draw_weights`): the CPU rounds p to bf16 before PV as the reference
    does, the card keeps it float32. For MoE
    the card's free routing is held by `routing_check` and its logits on
    a run that replays the CPU's expert choices (see
    `decode_consistency`); for a recurrent trunk the free run is printed
    and the card is held on a run whose blocks are fed the CPU's inputs
    (`BlockTape`)."""
    import torch
    from repro_torch.launch.train import cut_depth
    from repro_torch.models.moe import RouteTape
    from repro_torch.models.transformer import forward, trunk_kind
    cut = cut_depth(cfg, 2)   # a hybrid keeps its shared block last
    name = "card vs CPU, 2 layers"
    card = draw_weights(cut, dev)
    cpu = host_result(host, name, card)
    want = cpu["want"]
    with RouteTape() as card_tape:
        got = forward(card, on(dev, batch))[0].float().cpu()
    if trunk_kind(cut) != "attn":
        # see `BlockTape`: held block by block, the free run printed
        hold_logits(name + ", free-running (printed, not held)", got, want,
                    held=False)
        card_tape = BlockTape(card)
        card_tape.ins, card_tape.outs = cpu["ins"], cpu["outs"]
        with card_tape.replay(lambda t: t.to(dev)):
            got = forward(card, on(dev, batch))[0].float().cpu()
        print(f"{name}, each block fed the CPU's input: every block output "
              f"within rtol/atol 0.15; the largest difference "
              f"{card_tape.worst[0]:.4f} at call {card_tape.worst[1]}")
        name += ", each block fed the CPU's input"
    elif cut.is_moe:
        routing_check(name, types.SimpleNamespace(experts=cpu["experts"],
                                                  margins=cpu["margins"]),
                      torch.stack(card_tape.experts), got, want)
        with RouteTape(cpu["experts"]):
            got = forward(card, on(dev, batch))[0].float().cpu()
        name += ", the CPU's routing replayed"
    hold_logits(name, got, want)


def serve_view(model):
    """The model phase 10 serves: for a config of `SERVE_CUT`, a
    `Transformer` over the first `SERVE_LAYERS` of ``model``'s layers (its
    tensors, not copies; `cut_depth`'s config: a hybrid keeps its shared
    block); else ``model``."""
    from repro_torch.launch.train import cut_depth
    from repro_torch.models.transformer import Transformer, param_tree
    cfg = model.cfg
    if cfg.name not in SERVE_CUT or cfg.num_layers <= SERVE_LAYERS:
        return model
    tree = param_tree(model)
    tree["layers"] = tree["layers"][:SERVE_LAYERS]
    return Transformer(cut_depth(cfg, SERVE_LAYERS), tree)


def serve_lm(dev, model) -> dict:
    """Phase 10: the reference's continuous-batching server on ``model``
    (`serve_view`)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.models.layers import hot_vocab_size

    cfg = model.cfg
    reqs = S.synthetic_requests(8, cfg.vocab_size, seed=0)
    reset_lm_launches()
    S.decode_steps = 0
    t0 = time.perf_counter()
    done = S.serve_loop(cfg, model, reqs, batch_slots=4, max_len=512)
    seconds = time.perf_counter() - t0
    launches = lm_launches()
    steps = S.decode_steps
    if sorted(r.rid for r in done) != list(range(8)):
        raise AssertionError("not every request completed")
    for r in done:
        if len(r.out) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(r.out)} tokens "
                                 f"for max_new={r.max_new}")
    expected = {**flash_launches(cfg, 0), "hot_embed": steps,
                **gmm_launches(cfg, 4, steps)}
    if launches != expected:
        raise AssertionError(f"serve launches {launches} over {steps} "
                             f"decode steps, expected {expected}")
    toks = sum(len(r.out) for r in done)
    lat = [r.t_done - r.t_enqueue for r in done]
    print(f"[serve] {cfg.name} at {cfg.num_layers} layers: {len(done)} "
          f"requests, {toks} tokens in {seconds:.1f}s "
          f"({toks / seconds:.1f} tok/s aggregate); {steps} decode "
          f"steps, {1e3 * seconds / steps:.2f} ms each")
    print(f"[serve] latency p50 {np.percentile(lat, 50):.2f}s "
          f"p95 {np.percentile(lat, 95):.2f}s")
    print(f"[serve] completion order {[r.rid for r in done]}, launches "
          f"{launches} over {steps} decode steps")
    # the decode step's shape, (4,) ids, over every token the requests
    # fed or sampled, four at a time
    seen = [t for r in done for t in (*r.prompt.tolist(), *r.out)]
    ids = torch.tensor(seen[:len(seen) // 4 * 4], dtype=torch.int32,
                       device=dev).reshape(-1, 4)
    hot = hot_vocab_size(cfg)
    hot_err = max(hot_check("decode step", row, model.embed["table"], hot,
                            verbose=False) for row in ids)
    print(f"hot_gather[decode steps]: {ids.shape[0]} calls of 4 ids "
          f"({int((ids < hot).sum())} hot, hot={hot}) exact")
    return {"launches": launches, "seconds": seconds, "tokens": toks,
            "hot_err": hot_err}


def decode_profile(dev, model, steps: int = 5) -> None:
    """Where a decode step's wall goes: ``torch.profiler`` over a few
    steps at the served batch (4 slots, a 512-slot cache), device time
    summed over the kernels and copies it recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import decode_step, init_cache
    cache = init_cache(model.cfg, 4, 512, device=dev)
    tokens = torch.ones((4, 1), dtype=torch.int32, device=dev)
    for _ in range(3):
        _, cache = decode_step(model, cache, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _, cache = decode_step(model, cache, tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        print("decode profile: the profiler recorded no device time (not "
              "measured)")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in ops)
    top: dict = {}
    for e in ops:
        top[e.name] = top.get(e.name, 0) + e.time_range.elapsed_us()
    print(f"decode profile: {steps} steps, wall {wall_us / steps / 1e3:.2f} "
          f"ms/step, device busy {busy_us / steps / 1e3:.2f} ms/step "
          f"({100 * busy_us / wall_us:.1f}%), {len(ops) / steps:.0f} device "
          f"ops/step")
    for name, us in sorted(top.items(), key=lambda kv: -kv[1])[:6]:
        print(f"decode profile:   {us / steps / 1e3:8.3f} ms/step  "
              f"{name[:90]}")


def time_flash(cfg, q, k, v) -> dict:
    """Phase 11's flash timing on the prefill's real q, k, v: the kernel,
    its plain version, one SDPA call that computes the same function
    (timed only) and the bound, from the (row, key) pairs the config's
    mask lets through (`ref.visible_pairs`: a window's and a prefix's
    counted)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.flash_attn.ref import (attention_ref, visible,
                                                    visible_pairs)

    mask = flash_mask(cfg)
    bh, s, d = q.shape
    group = fa.kv_group(q, k, v)

    def plain_flash():   # one (b·h) row at a time
        for i in range(bh):
            j = i // group
            attention_ref(q[i:i + 1], k[j:j + 1], v[j:j + 1], **mask)
    flash = {"ms": cuda_ms(lambda: fa.flash_attention(q, k, v, **mask),
                           reps=5, warmup=1),
             "plain_ms": cuda_ms(plain_flash, reps=1, warmup=1)}
    # the library call, which rounds p to bf16: causal or bidirectional
    # SDPA; with a prefix or a window, which SDPA takes no argument for, an
    # explicit boolean (S, S) mask on the memory-efficient backend, which
    # takes no grouped kv, so k and v are repeated per head outside the
    # timed call
    if cfg.causal and (cfg.prefix_tokens > 0 or cfg.window > 0):
        pos = torch.arange(s, device=q.device)
        keep = visible(pos, pos, prefix=cfg.prefix_tokens,
                       window=cfg.window)[None, None]
        kr, vr = (t.repeat_interleave(group, 0)[None] for t in (k, v))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            flash["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q[None], kr, vr, attn_mask=keep), reps=5, warmup=1)
        what = "prefix" if cfg.prefix_tokens > 0 else "window"
        library = (f"F.scaled_dot_product_attention(attn_mask=bool (S, S) "
                   f"{what} mask, k/v repeated per head), efficient backend")
        del keep, kr, vr
        # a second yardstick, timed only: causal SDPA on the same q/k/v on
        # the first backend that takes it, which computes every causal
        # pair: it leaves out a prefix's p(p - 1)/2 pairs above the
        # diagonal and keeps those a window cuts
        def causal_sdpa():
            return F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True,
                enable_gqa=group > 1)
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION):
            try:
                with sdpa_kernel(backend):
                    causal_sdpa()
                    torch.cuda.synchronize()
            except RuntimeError:
                continue
            with sdpa_kernel(backend):
                flash["library_causal_ms"] = cuda_ms(causal_sdpa, reps=5,
                                                     warmup=1)
            flash["library_causal"] = (
                f"F.scaled_dot_product_attention(is_causal=True, enable_gqa="
                f"{group > 1}) on {backend.name}: causal only (no {what}), "
                f"timed only")
            break
        else:
            raise AssertionError("no SDPA backend takes the causal call")
    else:
        flash["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=cfg.causal,
                enable_gqa=group > 1), reps=5, warmup=1)
        library = (f"F.scaled_dot_product_attention(is_causal="
                   f"{cfg.causal}, enable_gqa={group > 1})")
    pairs = visible_pairs(s, **mask)
    flops = 4 * d * pairs * bh      # QK^T and PV
    # q read and o written, k and v read: BH / group rows each
    nbytes = (2 * bh + 2 * bh // group) * s * d * q.element_size()
    ops_ms, bytes_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    # the split PV multiplies p's bf16 high and low parts: 1.5x the FLOPs
    faithful = 6 * d * pairs * bh
    flash.update(bound_ms=max(ops_ms, bytes_ms),
                 bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                 faithful_bound_ms=max(faithful / BF16_FLOPS * 1e3,
                                       bytes_ms),
                 variant=fa.variant(q.dtype, d), group=group,
                 mask=fa.mask_kind(cfg.causal, cfg.prefix_tokens),
                 window=cfg.window if cfg.causal else 0,
                 pairs_per_head=pairs)
    print(f"flash_attention timing: {cfg.name} (BH, S, d)=({bh}, {s}, {d}) "
          f"bf16 group={group} variant={flash['variant']} "
          f"mask={flash['mask']} prefix={cfg.prefix_tokens} "
          f"window={flash['window']} pairs a head={pairs} "
          f"ms={flash['ms']:.4f} plain_ms={flash['plain_ms']:.4f} "
          f"library_ms={flash['library_ms']:.4f} ({library}, p rounded to "
          f"bf16) "
          + (f"library_causal_ms={flash['library_causal_ms']:.4f} "
             f"({flash['library_causal']}) " if "library_causal" in flash
             else "")
          + f"bound_ms={flash['bound_ms']:.4f} ({flops:.4e} FLOPs, "
          f"{flops / flash['ms'] / 1e9:.1f} TFLOP/s) "
          f"faithful_bound_ms={flash['faithful_bound_ms']:.4f} "
          f"({faithful:.4e} FLOPs, {faithful / flash['ms'] / 1e9:.1f} "
          f"TFLOP/s)")
    return flash


def time_lm_kernels(model, pre: dict) -> dict:
    """Phase 11: both LM kernels at the prefill's shapes (flash where the
    trunk has attention, the hot-slab gather where the input is
    tokens). The launch counters are put back after: timing launches are
    not the main path's."""
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.hot_embed import hot_embed as he
    kept = [(mod, name, copy.copy(getattr(mod, name))) for mod, name in (
        (fa, "launches"), (fa, "launches_by_variant"),
        (fa, "launches_by_mask"), (fa, "launches_grouped"),
        (fa, "launches_windowed"), (he, "launches"))]
    try:
        out = {}
        if pre["q"] is not None:
            out["flash_attn"] = time_flash(model.cfg, pre["q"], pre["k"],
                                           pre["v"])
        if pre["ids"] is not None:
            out["hot_embed"] = time_hot_gather(model, pre["ids"])
        return out
    finally:
        for mod, name, value in kept:
            setattr(mod, name, value)


def time_hot_gather(model, ids) -> dict:
    """The hot-slab gather on the prefill's ids against the served slab:
    the kernel, its plain version, ``F.embedding`` of all ids on the
    whole table (timed only) and the bound (ids read, each distinct hot
    row read once, the output written)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.hot_embed import hot_embed as he
    from repro_torch.kernels.hot_embed.ref import hot_gather_ref
    from repro_torch.models.layers import hot_vocab_size
    table = model.embed["table"]
    hot = hot_vocab_size(model.cfg)
    slab = table[:hot]
    n, dm = ids.numel(), table.shape[1]
    ids_long = ids.long()
    gather = {"ms": cuda_ms(lambda: he.hot_gather(ids, slab), reps=50),
              "plain_ms": cuda_ms(lambda: hot_gather_ref(ids, slab),
                                  reps=20),
              "library_ms": cuda_ms(lambda: F.embedding(ids_long, table),
                                    reps=50)}
    rows = int(torch.unique(ids[ids < hot]).numel())
    nbytes = 4 * n + 4 * dm * rows + 4 * n * dm
    gather.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                  D=dm, hot_rows=hot)
    print(f"hot_gather timing: ids={n} hot ids={int((ids < hot).sum())} "
          f"distinct hot rows={rows} D={dm} ms={gather['ms']:.4f} "
          f"plain_ms={gather['plain_ms']:.4f} "
          f"library_ms={gather['library_ms']:.4f} (F.embedding of all ids) "
          f"bound_ms={gather['bound_ms']:.4f} ({nbytes} bytes)")
    return gather


def host_ms(fn, reps: int = 200) -> float:
    """Mean host milliseconds a call: the wall of enqueuing ``reps`` calls
    after a synchronize (the device runs behind; nothing waits for it)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e3


def time_gmm(model, pre: dict, sweep: bool = True) -> tuple[dict, float]:
    """Phase 13: ``moe_gmm`` at the prefill's shapes (layer 0's real
    expert-sorted rows through the gate and the down products) and at a
    decode step's (the first 4 tokens x top-k: moonshot's 24 rows,
    mixtral-8x7b's 8), each with both
    bf16 variants, the plain version, one PyTorch call as a yardstick
    (``torch._grouped_mm``, timed only; the port never calls it) and the
    bound; at the decode shape, the wrapper's host ms a call, and device
    times taken queued (`cuda_ms`), since there the host's cost nears the
    device's. Then, with ``sweep``, a sweep of token counts over layer 0's
    routing (the first t tokens' rows): both variants' times, the variant
    the rule picks, and whether each variant repeats its bits. Returns the
    timings and the decode shapes' max |err| against the plain version."""
    import torch
    from repro_torch.kernels.moe_gmm import moe_gmm as gm
    from repro_torch.kernels.moe_gmm.ref import gmm_grouped_ref

    kept = gm.launches, dict(gm.launches_by_variant)
    cfg, blk, moe = model.cfg, model.layers[0], pre["moe"]
    e, topk = cfg.num_experts, cfg.experts_per_token
    bf16 = torch.bfloat16
    w_gate, w_down = (blk.ffn[n].to(bf16) for n in ("w_gate", "w_down"))
    flat = moe["experts"].reshape(-1)
    rank = torch.empty_like(flat)   # an assignment's row in moe["act"]
    rank[torch.argsort(flat, stable=True)] = torch.arange(
        flat.numel(), device=flat.device)

    def rows_of(t):
        """The first t tokens' gate and down inputs, sorted by expert."""
        mine = flat[:t * topk]
        order = torch.argsort(mine, stable=True)
        offs = torch.zeros(e + 1, dtype=torch.int32, device=mine.device)
        offs[1:] = torch.bincount(mine, minlength=e).cumsum(0)
        return (moe["y"][:t][order // topk].contiguous(),
                moe["act"][rank[order]].contiguous(), offs)

    def bound(x, w, offs):
        k, n = w.shape[1:]
        sizes = (offs[1:] - offs[:-1]).tolist()
        rows, used = sum(sizes), sum(c > 0 for c in sizes)
        flops = 2 * rows * k * n
        nbytes = 2 * rows * k + 2 * used * k * n + 2 * x.shape[0] * n \
            + 4 * (e + 1)
        ops_ms = flops / BF16_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (rows, used, flops, nbytes, max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes")

    def variant_ms(x, w, offs, v, reps, queued=False):
        return cuda_ms(lambda: gm.gmm(x, w, offs, out_dtype=bf16, variant=v),
                       reps=reps, warmup=1 if reps < 3 else 3, queued=queued)

    def one(name, x, w, offs, reps, decode=False):
        k, n = w.shape[1:]
        rows, used, flops, nbytes, bound_ms, bound_by = bound(x, w, offs)
        picked = gm.variant(x.shape[0], e, k, n)
        other = "splitk" if picked == "wgmma" else "wgmma"
        by_variant = {picked: variant_ms(x, w, offs, picked, reps,
                                         queued=decode)}
        out = {"variant": picked, "ms": by_variant[picked],
               "ms_by_variant": by_variant,
               "plain_ms": cuda_ms(lambda: gmm_grouped_ref(x, w, offs, bf16),
                                   reps=max(1, reps // 10), warmup=1)}
        if hasattr(torch, "_grouped_mm"):
            ends = offs[1:]
            out["library_ms"] = cuda_ms(
                lambda: torch._grouped_mm(x, w, offs=ends), reps=reps,
                queued=decode)
            lib = "torch._grouped_mm"
        else:
            bounds = offs.tolist()
            out["library_ms"] = cuda_ms(lambda: [
                torch.matmul(x[bounds[i]:bounds[i + 1]], w[i])
                for i in range(e)], reps=reps, queued=decode)
            lib = f"{e} torch.matmul"
        # last: split-K forced at a prefill's rows runs for a third of a
        # second, and what is timed right after it ran slower
        by_variant[other] = variant_ms(x, w, offs, other,
                                       reps if decode else 1, queued=decode)
        out.update(bound_ms=bound_ms, bound_by=bound_by)
        print(f"moe_gmm timing [{name}]: rows={rows} K={k} N={n} "
              f"experts used={used} variant={picked} ms={out['ms']:.4f} "
              f"(wgmma {by_variant['wgmma']:.4f}, splitk "
              f"{by_variant['splitk']:.4f}) plain_ms={out['plain_ms']:.4f} "
              f"library_ms={out['library_ms']:.4f} ({lib}) "
              f"bound_ms={bound_ms:.4f} ({flops:.4e} FLOPs, {nbytes} bytes; "
              f"{flops / out['ms'] / 1e9:.1f} TFLOP/s, "
              f"{nbytes / out['ms'] / 1e6:.1f} GB/s, "
              f"{100 * bound_ms / out['ms']:.1f}% of the bound)")
        if decode:
            out["host_ms"] = host_ms(
                lambda: gm.gmm(x, w, offs, out_dtype=bf16))
            print(f"moe_gmm timing [{name}]: host {out['host_ms']:.4f} ms a "
                  f"call (variant {picked}) beside {out['ms']:.4f} ms on the "
                  f"device")
        return out

    timing = one("prefill gate", moe["xs"], w_gate, moe["offs"], reps=20)
    timing["down"] = one("prefill down", moe["act"], w_down, moe["offs"],
                         reps=20)
    # a decode step at the served batch: 4 tokens, their top-k experts
    x, act, offs = rows_of(4)
    err = gmm_check("decode step gate", x, w_gate, offs)
    err = max(err, gmm_check("decode step down", act, w_down, offs))
    timing["decode"] = one("decode gate", x, w_gate, offs, reps=100,
                           decode=True)
    timing["decode_down"] = one("decode down", act, w_down, offs, reps=100,
                                decode=True)
    timing["by_variant"] = {
        v: {"shape": shape, **{key: entry[key] for key in
                               ("ms", "library_ms", "bound_ms")},
            **({"host_ms": entry["host_ms"]} if "host_ms" in entry else {})}
        for v, shape, entry in (("wgmma", "prefill gate", timing),
                                ("splitk", "decode gate", timing["decode"]))}

    for t in SWEEP_TOKENS if sweep else ():
        x, act, offs = rows_of(t)
        rows = x.shape[0]
        reps = 20 if rows <= 6144 else 5
        for name, inp, w in (("gate", x, w_gate), ("down", act, w_down)):
            k, n = w.shape[1:]
            ms, same = {}, {}
            for v in ("wgmma", "splitk"):
                slow = v == "splitk" and rows > 6144   # forced far past
                ms[v] = variant_ms(inp, w, offs, v, 1 if slow else reps,
                                   queued=rows <= 96)
                first = gm.gmm(inp, w, offs, out_dtype=bf16, variant=v)
                same[v] = torch.equal(first, gm.gmm(inp, w, offs,
                                                    out_dtype=bf16,
                                                    variant=v))
                if not same[v]:
                    raise AssertionError(f"moe_gmm sweep [{name}, {t} "
                                         f"tokens, {v}]: two runs differ")
            used = int(((offs[1:] - offs[:-1]) > 0).sum())
            print(f"moe_gmm sweep [{name}]: tokens={t} rows={rows} "
                  f"rows/group={rows / e:.3f} experts used={used} "
                  f"wgmma {ms['wgmma']:.4f} ms, splitk {ms['splitk']:.4f} ms,"
                  f" faster {min(ms, key=ms.get)}, rule picks "
                  f"{gm.variant(rows, e, k, n)}, same bits "
                  f"{same['wgmma'] and same['splitk']}")
    # timing launches are not the main path's
    gm.launches, gm.launches_by_variant = kept
    return timing, err


def device_events(prof) -> list:
    """(name, start us, end us) of each device operation that ``prof`` (a
    finished ``torch.profiler.profile``) recorded, read from kineto's own
    events: building torch's ``FunctionEvent``s for a training step's
    several hundred thousand operations takes minutes."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def device_ops(fn) -> tuple[int, float]:
    """(device operations, their summed ms) of one synchronised ``fn()``
    under ``torch.profiler``, the device's activity alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = device_events(prof)
    return len(ops), sum(end - start for _, start, end in ops) / 1e3


def scan_call(model, batch):
    """(name, chunk, chunks, the scan, its inputs) of the recurrent trunk's
    layer-0 scan on ``batch``: rwkv's chunked wkv (`_wkv_chunked`) or the
    hybrid's SSD (`ssd_chunked`) on the inputs the layer hands it; the
    scan takes its inputs and returns its (B, T, ...) output."""
    from repro_torch.models import mamba2, rwkv6
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.transformer import embed_inputs, trunk_kind
    cfg, blk = model.cfg, model.layers[0]
    x = apply_norm(blk.norm1, embed_inputs(model, batch), cfg)
    if trunk_kind(cfg) == "rwkv":
        h, dh = rwkv6.heads_of(cfg)
        r, k, v, _, logw = rwkv6._wkv_inputs(blk.rwkv, x)
        chunk = rwkv6.WKV_CHUNK
        return ("wkv (_wkv_chunked)", chunk, x.shape[1] // chunk,
                lambda *a: rwkv6._wkv_chunked(*a, h, dh)[0],
                [r, k, v, logw, blk.rwkv["u_bonus"]])
    _, xh, dt, b, c, _ = mamba2._mixer_inputs(blk.mamba, x, cfg)
    chunk = cfg.ssm_chunk
    return ("SSD (ssd_chunked)", chunk, x.shape[1] // chunk,
            lambda *a: mamba2.ssd_chunked(*a, chunk),
            [xh, dt, b, c, blk.mamba["a_log"]])


def time_scan_grad(scan, inputs, chunks: int) -> dict:
    """The scan's forward plus backward (against a cotangent of ones, every
    input a leaf): device ms (CUDA events, 3 calls), device ops and their
    ms (`device_ops`), the GiB the forward leaves allocated (what it saves
    for the backward, and its output);
    and the state loop's own share (`layers.carry_states` on the scan's
    real operands, forward alone and forward plus backward)."""
    import torch
    from repro_torch.models import layers, mamba2, rwkv6
    kept = []

    def keep(delta, decay):
        kept[:] = [delta.detach(), decay.detach()]
        return layers.carry_states(delta, decay)

    def fwd_bwd():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        y = scan(*leaves)
        y.backward(torch.ones_like(y))

    rwkv6.carry_states = mamba2.carry_states = keep
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        y = scan(*[t.detach().requires_grad_(True) for t in inputs])
        saved = (torch.cuda.memory_allocated() - base) / 2**30
        del y
    finally:
        rwkv6.carry_states = mamba2.carry_states = layers.carry_states
    delta, decay = (t.requires_grad_(True) for t in kept)

    def loop_fwd_bwd():
        states = layers.carry_states(delta, decay)
        torch.autograd.backward(states[1:], [torch.ones_like(states[1])]
                                * chunks)

    ms = cuda_ms(fwd_bwd, reps=3, warmup=1)
    ops, busy = device_ops(fwd_bwd)
    loop_fwd, _ = device_ops(lambda: layers.carry_states(delta, decay))
    loop_ops, loop_busy = device_ops(loop_fwd_bwd)
    return {"ms": ms, "ops": ops, "busy_ms": busy, "saved_gib": saved,
            "loop_fwd_ops": loop_fwd, "loop_bwd_ops": loop_ops - loop_fwd,
            "loop_busy_ms": loop_busy}


def time_scan(model, batch) -> dict:
    """The recurrent trunk's scan on layer 0 (`scan_call`), plain torch: at
    the prefill's shapes its forward (device ms from CUDA events, the
    device's busy ms and the device ops one call launches from
    `torch.profiler`; times the layers, those ops are the scan's host
    launches a prefill, one a chunk of them the state loop's), then its
    forward plus backward (`time_scan_grad`) there and at a training
    microbatch (`TRAIN_MICROBATCH` x `TRAIN_SEQ` of the same tokens)."""
    import torch
    cfg = model.cfg
    name, chunk, chunks, scan, inputs = scan_call(model, batch)
    s = chunks * chunk
    ms = cuda_ms(lambda: scan(*inputs), reps=3, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan(*inputs)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ops, busy_ms = device_ops(lambda: scan(*inputs))
    layers = cfg.num_layers
    out = {"scan": name, "ms": ms, "wall_ms": wall_ms,
           "busy_ms": busy_ms if ops else None, "ops": ops,
           "state_loop_launches": chunks,
           "prefill_launches": ops * layers,
           "prefill_state_loop_launches": chunks * layers}
    print(f"scan: {cfg.name} layer 0 {name} at S={s}, {chunks} chunks of "
          f"{chunk}: ms={ms:.4f} (CUDA events, 3 calls), wall_ms="
          f"{wall_ms:.4f} (one synchronised call), device busy "
          + (f"{busy_ms:.4f} ms, {ops} device ops a call"
             if ops else "not measured (the profiler recorded no device "
             "time)")
          + f"; {chunks} of them the state loop's (one a chunk); a "
          f"prefill of {layers} layers: {ops * layers} launches, "
          f"{chunks * layers} from the state loops")
    micro = {k: v.reshape(-1, TRAIN_SEQ)[:TRAIN_MICROBATCH]
             for k, v in batch.items()}
    del inputs
    for label, b in (("prefill", batch), ("train", micro)):
        _, _, chunks, scan, inputs = scan_call(model, b)
        g = time_scan_grad(scan, inputs, chunks)
        del inputs
        torch.cuda.empty_cache()
        out[f"{label}_fwd_bwd"] = g
        print(f"scan forward and backward [{label}]: {cfg.name} layer 0 "
              f"{name} at {tuple(b['tokens'].shape)} tokens, {chunks} "
              f"chunks: ms={g['ms']:.4f} (CUDA events, 3 calls), device "
              f"busy {g['busy_ms']:.4f} ms, {g['ops']} device ops a call; "
              f"the forward saves {g['saved_gib']:.3f} GiB for the "
              f"backward; the state loop alone {g['loop_fwd_ops']} device "
              f"ops forward and {g['loop_bwd_ops']} backward, busy "
              f"{g['loop_busy_ms']:.4f} ms")
    return out


def run_lm(dev, cfg, host, full_cfg=None) -> dict:
    """Phases 7-11 (and 13 for MoE) on one LM config, weights from
    ``init_params`` on the card (seed 7), its inputs from
    ``configs/shapes.input_specs`` (`lm_batch`); ``host``, the run's
    `HostPool`, takes phase 9's CPU half (`host_forward`) after the
    prefill; ``full_cfg`` is the config before its depth was cut (None:
    not cut). Phases whose cell
    ``cell_supported`` rules out (an encoder's decode: consistency, serve,
    decode profile) are skipped and say so. A recurrent trunk's scan is
    timed on layer 0 (`time_scan`). Frees the model before it returns."""
    import dataclasses
    import torch
    from repro_torch.configs.shapes import SHAPES, cell_supported
    from repro_torch.models.transformer import init_params, trunk_kind
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    torch.cuda.synchronize()
    print(f"init_params: {cfg.name}, L={cfg.num_layers}, "
          f"{sum(p.numel() for p in model.parameters())} parameters "
          f"(float32 masters; the config's analytic param_count "
          f"{cfg.param_count()}) in {time.perf_counter() - t0:.1f} s")
    if full_cfg is not None:
        print(f"cut: {cfg.num_layers} of {full_cfg.num_layers} layers at "
              f"full width; the full config has {full_cfg.param_count()} "
              f"parameters, the cut one {cfg.param_count()}")
    shape = dataclasses.replace(SHAPES[PREFILL_SHAPE], global_batch=1)
    seq = PREFILL_TOKENS or shape.seq_len
    tokens = (None if cfg.input_mode == "embeddings"
              else token_source(cfg, seq))
    batch = lm_batch(cfg, tokens, 1, seq)
    pre = prefill(dev, model, batch)
    # phase 9's CPU half, submitted once the prefill's checks, which hold
    # the card's most memory, are done: the worker draws its weights there
    cpu_batch = lm_batch(cfg, tokens, 3, 256 + cfg.prefix_tokens)
    cpu = host.forward(cfg, cpu_batch)
    decode, why = cell_supported(cfg, SHAPES["decode_32k"])
    if decode:
        decode_consistency(dev, model, tokens(2, 64))
    else:
        print(f"decode vs forward: skipped for {cfg.name}: {why}")
    card_vs_cpu(dev, cfg, cpu_batch, cpu)
    lm = {"launches": {}, "hot_err": 0.0}
    if decode:
        lm = serve_lm(dev, serve_view(model))
        decode_profile(dev, model)
    else:
        print(f"serve and decode profile: skipped for {cfg.name}: {why}")
    out = {"timing": time_lm_kernels(model, pre), "pre": pre["launches"],
           "serve": lm["launches"], "flash_err": pre["err"],
           "hot_err": max(pre["hot_err"], lm["hot_err"])}
    if cfg.is_moe:
        # the variant sweep places moonshot's crossover; mixtral's 8
        # experts are timed at its prefill and decode shapes only
        out["gmm_timing"], err = time_gmm(model, pre,
                                          sweep=cfg.name == MOE_ARCH)
        out["gmm_err"] = max(pre["moe"]["err"], err)
    if trunk_kind(cfg) != "attn":
        out["scan"] = time_scan(model, on(dev, batch))
    del model, pre
    torch.cuda.empty_cache()
    return out


def ring_decode_check(dev) -> None:
    """Phase 13's window past its end: smoke mixtral-8x7b (window 8, so its
    attention cache is an 8-slot ring, `layers.init_attn_cache`) with the
    same weights (`init_params`, seed `SEED`) on the CPU and the card,
    teacher-forced through `decode_step` for `RING_STEPS` tokens, so that
    the ring wraps twice; the card's free routing held by `routing_check`,
    its logits by `hold_logits` on a run that replays the CPU's expert
    choices (tests/test_torch_models.py holds the CPU's decode to the
    reference's on the same path). At full width the served lengths never
    reach 4,096 positions, so the ring never wraps there."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models.moe import RouteTape
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_params)
    cfg = smoke_config(SWA_ARCH)
    host = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    card = copy.deepcopy(host).to(dev)
    n, layers = RING_STEPS, cfg.num_layers
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int32))

    def decode(model, device, replay=None):
        cache = init_cache(cfg, 1, n, device=device)
        slots = cache["layers"]["k"].shape[2]
        if slots != cfg.window:
            raise AssertionError(f"{slots} cache slots for window "
                                 f"{cfg.window}")
        steps = []
        with RouteTape(replay) as tape:
            for i in range(n):
                lg, cache = decode_step(model, cache,
                                        tokens[:, i:i + 1].to(device))
                steps.append(lg[:, 0].float().cpu())
        return torch.stack(steps, dim=1), tape

    want, cpu_tape = decode(host, "cpu")
    got, card_tape = decode(card, dev)
    name = (f"ring decode [{cfg.name} smoke, window {cfg.window}, {n} "
            f"steps], card vs CPU")

    def by_layer(t):   # a step routes one position through every layer
        return torch.stack(t).reshape(n, layers, -1).transpose(0, 1)
    routing_check(name, types.SimpleNamespace(
        experts=list(by_layer(cpu_tape.experts)),
        margins=list(by_layer(cpu_tape.margins)[..., 0])),
        by_layer(card_tape.experts), got, want)
    got, _ = decode(card, dev, cpu_tape.experts)
    hold_logits(name + ", the CPU's routing replayed", got, want)


def lm_configs() -> dict:
    """Phases 7-13's configs by arch, in the order they run: (the config at
    full width, its depth cut for the MoE models; the full config where it
    was cut, else None)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    out = {arch: (get_config(arch), None)
           for arch in (ARCH, GQA_ARCH, PREFIX_ARCH, ENCODER_ARCH, RWKV_ARCH,
                        HYBRID_ARCH, GLM_ARCH, CODE_ARCH)}
    for arch, layers in ((MOE_ARCH, MOE_LAYERS), (SWA_ARCH, SWA_LAYERS)):
        full = get_config(arch)
        out[arch] = (cut_depth(full, layers), full)
    return out


# ------------------------------------------------------------- training
def _plain_attention(q, k, v, prefix: int = 0, window: int = 0):
    """Causal attention (rows below ``prefix`` see every key below it; a
    ``window`` keeps the keys less than it behind a row) in the inputs'
    dtype throughout, k and v repeated per query row: in bf16
    FlashAttention's plain bf16 path, in float64 its oracle."""
    import torch
    from repro_torch.kernels.flash_attn.ref import visible
    bh, s, d = q.shape
    group = bh // k.shape[0]
    k, v = k.repeat_interleave(group, 0), v.repeat_interleave(group, 0)
    logits = torch.einsum("bqd,bkd->bqk", q, k) * d ** -0.5
    pos = torch.arange(s, device=q.device)
    logits = torch.where(visible(pos, pos, prefix=prefix,
                                 window=window)[None], logits, -1e30)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(logits, dim=-1), v)


def _grads_of(fn, q, k, v, do, dtype, prefix, window):
    import torch
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in (q, k, v)]
    return torch.autograd.grad(fn(*leaves, prefix=prefix, window=window),
                               leaves, do.to(dtype))


def bwd_group_launches(since: dict) -> dict:
    """The backward's kernel launches by kv group since ``since`` (a copy
    of `flash_attn.launches_bwd_by_group`), the groups with any."""
    from repro_torch.kernels.flash_attn import flash_attn as fa
    return {g: n - since.get(g, 0)
            for g, n in sorted(fa.launches_bwd_by_group.items())
            if n != since.get(g, 0)}


def bwd_mask_text(prefix: int, window: int) -> str:
    return ("causal" + (f" with a {prefix}-row prefix" if prefix else "")
            + (f", window {window}" if window else ""))


def flash_bwd_check(name, variant, bh, kv, s, d, prefix, window,
                    dev) -> float:
    """The backward kernels, causal with a ``prefix`` and a ``window`` (0:
    none), at FlashAttention's standard: dq, dk and dv each at most 2x
    (plus 1e-3)
    the max error of the plain bf16 path against a float64 autograd
    oracle, both taken a kv head's query group at a time; a repeat gives
    the same bits; both calls launch the two kernels of ``variant`` and
    nothing else; held to the plain version (`attention_bwd_ref`, the same
    recompute in float32) at rtol 2e-2 and 2e-2 of the largest gradient.
    Returns the max |err| against the plain version."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.flash_attn.ref import attention_bwd_ref
    gen = torch.Generator(device=dev).manual_seed(SEED + d)

    def draw(rows):
        return torch.randn((rows, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
    q, do, k, v = draw(bh), draw(bh), draw(kv), draw(kv)
    mask = dict(prefix=prefix, window=window)
    o, lse = fa.flash_attention_lse(q, k, v, **mask)
    by0 = dict(fa.launches_bwd_by_variant)
    group0 = dict(fa.launches_bwd_by_group)
    windowed0 = fa.launches_bwd_windowed
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash backward[{name}]: two runs differ")
    group = bh // kv
    launched = {x: fa.launches_bwd_by_variant[x] - by0[x] for x in by0}
    by_group = bwd_group_launches(group0)
    windowed = fa.launches_bwd_windowed - windowed0
    if (launched != {x: 4 if x == variant else 0 for x in by0}
            or by_group != {group: 4} or windowed != 4 * (window > 0)):
        raise AssertionError(f"flash backward[{name}]: launches by variant "
                             f"{launched}, by group {by_group}, windowed "
                             f"{windowed}; expected 4 {variant} at group "
                             f"{group}")
    err = {c: 0.0 for c in "qkv"}
    base = dict(err)
    heads = max(1, 8 // group)          # kv heads a chunk: 8 query rows
    for j in range(0, kv, heads):
        rows = slice(j * group, (j + heads) * group)
        kvr = slice(j, j + heads)
        args = (q[rows], k[kvr], v[kvr], do[rows])
        oracle = _grads_of(_plain_attention, *args, torch.float64, prefix,
                           window)
        plain = _grads_of(_plain_attention, *args, torch.bfloat16, prefix,
                          window)
        mine = (got[0][rows], got[1][kvr], got[2][kvr])
        for c, g, o_, p_ in zip("qkv", mine, oracle, plain):
            err[c] = max(err[c], float((g.double() - o_).abs().max()))
            base[c] = max(base[c], float((p_.double() - o_).abs().max()))
        del oracle, plain
    for c in "qkv":
        if err[c] > 2 * base[c] + 1e-3:
            raise AssertionError(
                f"flash backward[{name}] d{c}: {err[c]:.3e} against the "
                f"float64 oracle, the plain bf16 path's {base[c]:.3e}")
    want = attention_bwd_ref(q, k, v, o, lse, do, **mask)
    plain_err = 0.0
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                   atol=2e-2 * scale)
        plain_err = max(plain_err, float((g.float() - w.float()).abs().max()))
    print(f"flash backward[{name}]: (BH, S, d)=({bh}, {s}, {d}) over {kv} "
          f"kv rows (group {group}), {bwd_mask_text(prefix, window)}, "
          f"{variant}; max |err| against the float64 oracle "
          + ", ".join(f"d{c} {err[c]:.3e} (plain bf16 path {base[c]:.3e})"
                      for c in "qkv")
          + f"; against attention_bwd_ref {plain_err:.3e}; bits repeat")
    return plain_err


def bwd_pairs(s: int, prefix: int = 0, window: int = 0,
              step: int = 64) -> tuple[int, int]:
    """(pairs, blocks) of a causal mask with ``prefix`` and ``window`` over
    S ``s``, a head: the (row, key) pairs it lets through
    (`ref.visible_pairs`), and the 64-row by 64-key blocks (``step``) with
    at least one of them, which the ``wgmma`` backward kernels multiply
    whole (a block with none they skip). A block of rows r and keys c
    holds a causal pair where some r - c lies in [0, window), and a
    prefix pair where some r and c lie below the prefix with r - c below
    the window."""
    import numpy as np
    from repro_torch.kernels.flash_attn.ref import visible_pairs
    p = min(prefix, s)
    w = window if window > 0 else s
    first = np.arange(0, s, step)
    last = np.minimum(first + step, s) - 1
    r0, r1, c0, c1 = first[:, None], last[:, None], first[None], last[None]
    causal = (r1 - c0 >= 0) & (r0 - c1 < w)
    pre = (r0 < p) & (c0 < p) & (r0 - np.minimum(c1, p - 1) < w)
    return (visible_pairs(s, prefix=prefix, window=window),
            int((causal | pre).sum()))


def time_flash_bwd(bh, kv, s, d, prefix, window, dev) -> dict:
    """The backward kernels timed at one of `BWD_TIMING` (causal, with a
    ``prefix`` and a ``window`` where it has them): each kernel alone
    (`flash_attn.backward_launches`; the dk/dv kernel reads the dq
    kernel's rows, written once before), the pair as `flash_attention_bwd`
    runs it, their plain version, and the backward alone of
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    on the backend it takes (causal only: without a prefix's extra pairs
    and with the pairs a window cuts, so timed only; ``library_ms`` None,
    with the refusals, where no backend takes it).
    The bound: the five products of the math, 2·d FLOPs a visible (row,
    key) pair each (`bwd_pairs`: a window's and a prefix's counted), at
    the card's bf16 rate (and the seven the two kernels issue: dq
    recomputes S and dP); ``issued_flops`` counts what the kernels
    multiply: seven products over every 64 x 64 block that holds a
    visible pair. Each kernel's TFLOP/s counts its own products over the
    visible pairs (dq: S, dP, dQ; dk/dv: S, dP, dV, dK)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.flash_attn.ref import attention_bwd_ref
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def draw(rows):
        return torch.randn((rows, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
    q, do, k, v = draw(bh), draw(bh), draw(kv), draw(kv)
    mask = dict(prefix=prefix, window=window)
    o, lse = fa.flash_attention_lse(q, k, v, **mask)
    _, launch_dq, launch_dkdv = fa.backward_launches(q, k, v, o, lse, do,
                                                     **mask)
    launch_dq()
    out = {"shape": [bh, kv, s, d], "prefix": prefix, "window": window,
           "variant": fa.bwd_variant(q.dtype, d),
           "ms": cuda_ms(lambda: fa.flash_attention_bwd(
               q, k, v, o, lse, do, **mask), reps=20, warmup=2),
           "dq_ms": cuda_ms(launch_dq, reps=20, warmup=2),
           "dkdv_ms": cuda_ms(launch_dkdv, reps=20, warmup=2),
           # the training forward's call, for the step's breakdown
           "forward_lse_ms": cuda_ms(lambda: fa.flash_attention_lse(
               q, k, v, **mask), reps=10, warmup=2),
           "plain_ms": cuda_ms(lambda: attention_bwd_ref(
               q, k, v, o, lse, do, **mask), reps=1, warmup=1)}
    backend, refused = None, []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION):
        leaves = [t[None].detach().requires_grad_(True) for t in (q, k, v)]
        try:
            with sdpa_kernel(b):
                y = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                   enable_gqa=True)
                torch.autograd.grad(y, leaves, do[None], retain_graph=True)
        except RuntimeError as e:
            refused.append(f"{b.name}: {str(e).splitlines()[0][:160]}")
            continue
        backend = b
        break
    if backend is None:
        out.update(library_ms=None, library="no SDPA backend takes a "
                   "grouped causal backward here: " + "; ".join(refused))
    else:
        with sdpa_kernel(backend):
            out["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                y, leaves, do[None], retain_graph=True), reps=10, warmup=2)
        out["library"] = (f"F.scaled_dot_product_attention(is_causal=True, "
                          f"enable_gqa=True) backward on {backend.name}"
                          + (", causal only, timed only" if prefix or window
                             else ""))
    pairs, blocks = bwd_pairs(s, prefix, window)
    product = 2 * d * pairs * bh    # FLOPs of one product
    nbytes = (4 * bh + 4 * kv) * s * d * 2 + bh * s * 4
    ops_ms = 5 * product / BF16_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out.update(pairs_per_head=pairs, blocks_per_head=blocks,
               bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               bound_flops=5 * product,
               bound7_ms=7 * product / BF16_FLOPS * 1e3,
               issued_flops=7 * 2 * d * 64 * 64 * blocks * bh,
               dq_tflops=3 * product / out["dq_ms"] / 1e9,
               dkdv_tflops=4 * product / out["dkdv_ms"] / 1e9)
    lib = ("refused" if out["library_ms"] is None
           else f"{out['library_ms']:.4f}")
    print(f"flash backward timing: (BH, S, d)=({bh}, {s}, {d}) over {kv} kv "
          f"rows (group {bh // kv}), {bwd_mask_text(prefix, window)}, "
          f"{pairs} pairs and {blocks} blocks a head, "
          f"{out['variant']}: ms={out['ms']:.4f} (dq "
          f"{out['dq_ms']:.4f} ms, {out['dq_tflops']:.1f} TFLOP/s of its "
          f"three products; dkdv {out['dkdv_ms']:.4f} ms, "
          f"{out['dkdv_tflops']:.1f} TFLOP/s of its four; "
          f"{5 * product / out['ms'] / 1e9:.1f} TFLOP/s of the five, "
          f"{out['issued_flops'] / out['ms'] / 1e9:.1f} of the "
          f"{out['issued_flops']:.4e} FLOPs issued) forward with lse "
          f"{out['forward_lse_ms']:.4f} ms; plain_ms={out['plain_ms']:.4f} "
          f"library_ms={lib} ({out['library']}, p rounded to bf16) "
          f"bound_ms={out['bound_ms']:.4f} at five products "
          f"({5 * product:.4e} FLOPs), {out['bound7_ms']:.4f} at seven")
    return out


# the template argument (float or bf16 dW) in gmm_bf16_tgmm's mangled names
TGMM_PTXAS_KEY = r"tgmmI(f|13__nv_bfloat16)E"
# both of flash_fwd_bf16_wgmma's (head dim, kLse): "256,1" is <256, true>
FLASH_FWD_PTXAS_KEY = r"wgmmaILi(\d+)ELb([01])E"
FLASH_FWD_INSTANCES = {f"{d},{lse}" for d in (64, 80, 128, 256)
                       for lse in (0, 1)}
# the head dims of the backward's two Hopper kernels, each gated
FLASH_BWD_KERNELS = ("flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")
FLASH_BWD_INSTANCES = {"64", "80", "128", "256"}


def ptxas_numbers(name: str, kernel: str,
                  key: str = r"ILi(\d+)E") -> dict:
    """ptxas's registers, spill stores and loads (bytes) and stack frame
    of each instantiation of ``kernel`` in library ``name``, keyed by the
    template arguments that ``key`` captures in its mangled name (by
    default a head dim; several, joined by commas), from the build log;
    ``serialized`` lists the C75xx advisories that its ``wgmma``s were
    serialised."""
    import re
    from repro_torch.kernels import _build
    out: dict = {}
    dim = None
    for line in _build.ptxas_report(name, kernel):
        m = re.search(key, line)
        if re.search(r"\(C75\d\d\)", line) and m:
            out.setdefault(",".join(m.groups()), {}).setdefault(
                "serialized", []).append(line)
            continue
        if "Compiling entry function" in line:
            # an entry that the key does not match counts under no key
            dim = ",".join(m.groups()) if m else None
            if dim:
                out.setdefault(dim, {}).setdefault("serialized", [])
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and dim:
            out[dim].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and dim:
            out[dim]["registers"] = int(m.group(1))
    return out


def ptxas_gate(name: str, kernel: str, key: str, instances: set) -> dict:
    """`ptxas_numbers` of ``kernel``, printed; raises unless it lists
    exactly ``instances``, each with no spill and no C75xx advisory that
    its ``wgmma``s were serialised."""
    got = ptxas_numbers(name, kernel, key)
    print(f"{kernel} ptxas: {json.dumps(got)}")
    if set(got) != instances or any(
            v.get("spill_stores", 1) or v.get("spill_loads", 1)
            or v["serialized"] for v in got.values()):
        raise AssertionError(f"{kernel}: ptxas spilled, serialised its "
                             f"wgmma or left no report (instances "
                             f"{sorted(instances)})")
    return got


def with_prefix(cfg, tokens, dev) -> dict:
    """The train batch of ``tokens`` on ``dev``: for a prefix-LM, beside
    them a prefix of zero embeddings, as the reference's trainer builds it
    (src/repro/launch/train.py:138-140)."""
    import torch
    batch = {"tokens": tokens.to(dev)}
    if cfg.prefix_tokens:
        batch["prefix"] = torch.zeros(
            (tokens.shape[0], cfg.prefix_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    return batch


def train_full_width(dev, cfg, steps: int = TRAIN_STEPS,
                     profile_rows: int = TRAIN_BATCH) -> dict:
    """``cfg`` at full width (qwen2.5-3b, paligemma-3b, rwkv6-3b and
    zamba2-1.2b at full depth; moonshot, chatglm3-6b, starcoder2-7b and
    mixtral-8x7b cut in depth, `TRAIN_DEPTH`), remat on, trained
    for ``steps`` steps through
    `train.steps.make_train_step`: a global batch of `TRAIN_BATCH` x
    `TRAIN_SEQ` positions (``train_4k``'s sequence; its batch of 256 cut
    to 8), tokens from the Zipf corpus through the vocab LOrder
    (``data.pipeline.DataLoader``) after a prefix-LM's prefix of zero
    embeddings (`with_prefix`), microbatches of 2 sequences. The
    launch counts are zeroed just before the steps and read just after;
    one microbatch first checks that no gradient leaf is all zero (a
    kernel output without an autograd graph would leave one so) and, for
    an MoE, keeps layer 0's weight-gradient operands (`tgmm`'s x, dy and
    offsets of its three products, from that backward) and its bf16
    expert stacks under ``"layer0"``. The profiled step (`profile_train_step`)
    takes the last batch's first ``profile_rows`` sequences."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, DataLoader
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.launch.train import build_vocab_reorder
    from repro_torch.models.transformer import (init_params, loss_fn,
                                                param_tree)
    from repro_torch.train.optim import TrainConfig, init_opt_state
    from repro_torch.train.steps import make_train_step

    if not cfg.remat:
        raise AssertionError(f"{cfg.name} trains with remat")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    n_params = sum(p.numel() for p in model.parameters())
    dc = DataConfig(vocab_size=cfg.vocab_size,
                    seq_len=TRAIN_SEQ - cfg.prefix_tokens,
                    global_batch=TRAIN_BATCH)
    vr = build_vocab_reorder(cfg, dc)
    vr.apply_to_params(model)
    opt = init_opt_state(param_tree(model))
    torch.cuda.synchronize()
    print(f"train: {cfg.name} L={cfg.num_layers} {n_params} parameters "
          f"(param_count {cfg.param_count()}), remat {cfg.remat_policy}, "
          f"weights, LOrder and AdamW state in "
          f"{time.perf_counter() - t0:.1f} s")
    loader = DataLoader(dc, vr, start_step=1)   # batch 0 built the LOrder
    try:
        batches = [torch.from_numpy(next(loader)["tokens"])
                   for _ in range(steps)]
    finally:
        loader.close()

    # one microbatch's gradients: every leaf reached
    mb = with_prefix(cfg, batches[0][:TRAIN_MICROBATCH], dev)
    for p in model.parameters():
        p.requires_grad_(True)
    reset_lm_launches()
    bwd0 = dict(fa.launches_bwd)
    kept = []   # the last 3 weight gradients: layer 0's, in backward order
    tgmm = gmm_ops.tgmm

    def keep(x, dy, offs, **kw):
        kept[:] = kept[-2:] + [(x.detach(), dy.detach(), offs)]
        return tgmm(x, dy, offs, **kw)
    gmm_ops.tgmm = keep
    try:
        loss, _ = loss_fn(model, mb)
        loss.backward()
    finally:
        gmm_ops.tgmm = tgmm
    torch.cuda.synchronize()
    one = {**lm_launches(), "flash_bwd_dq": fa.launches_bwd["dq"] - bwd0["dq"],
           "flash_bwd_dkdv": fa.launches_bwd["dkdv"] - bwd0["dkdv"]}
    zero = [n for n, p in model.named_parameters()
            if p.grad is None or not bool(p.grad.any())]
    bad = [n for n, p in model.named_parameters()
           if not bool(torch.isfinite(p.grad).all())]
    for p in model.parameters():
        p.grad = None
        p.requires_grad_(False)
    if zero or bad:
        raise AssertionError(f"gradient leaves all zero {zero[:8]} or not "
                             f"finite {bad[:8]}")
    print(f"train: one microbatch's backward reaches all "
          f"{len(list(model.parameters()))} leaves, none all zero; launches "
          f"{one}")
    layer0 = None
    if cfg.is_moe:
        # autograd runs a layer's down product's backward first and the
        # gate's last
        down, gate = kept[0], kept[-1]
        if (down[0].shape[1], gate[0].shape[1]) != (cfg.d_ff, cfg.d_model):
            raise AssertionError("layer 0's weight gradients came in another "
                                 "order")
        ffn = model.layers[0].ffn
        layer0 = {"gate": gate, "down": down,
                  **{n: ffn[n].to(torch.bfloat16)
                     for n in ("w_gate", "w_down")}}
        sizes = (down[2][1:] - down[2][:-1]).tolist()
        print(f"train: layer 0's routing at a microbatch: "
              f"{int(down[2][-1])} rows over {cfg.num_experts} experts "
              f"({int(down[2][-1]) / cfg.num_experts:.1f} a group on "
              f"average), group sizes min {min(sizes)} max {max(sizes)}, "
              f"{sizes.count(0)} empty: {sizes}")
    del kept

    # the reference's TrainConfig defaults: lr 3e-4 after 100 warmup
    # steps, so these steps run at 3e-6 to 1.8e-5
    tc = TrainConfig(microbatch=TRAIN_MICROBATCH)
    step = make_train_step(cfg, tc)
    losses, rows = [], []
    reset_lm_launches()
    bwd0 = dict(fa.launches_bwd)
    by0 = dict(fa.launches_bwd_by_variant)
    group0 = dict(fa.launches_bwd_by_group)
    windowed0 = fa.launches_bwd_windowed
    for i, tokens in enumerate(batches):
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        model, opt, m = step(model, opt, with_prefix(cfg, tokens, dev))
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses.append(loss)
        # positions a second: the prefix's rows run through the trunk too
        rows.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]), "seconds": dt,
                     "tokens_per_s": tokens.shape[0] * TRAIN_SEQ / dt,
                     "peak_gib": peak})
        print(f"train step {i} [{cfg.name}]: loss {loss:.4f} grad_norm "
              f"{rows[-1]['grad_norm']:.3f} lr {rows[-1]['lr']:.2e} "
              f"{dt:.3f} s ({rows[-1]['tokens_per_s']:.1f} tokens/s) peak "
              f"{peak:.1f} GiB")
    launches = {**lm_launches(),
                "flash_bwd_dq": fa.launches_bwd["dq"] - bwd0["dq"],
                "flash_bwd_dkdv": fa.launches_bwd["dkdv"] - bwd0["dkdv"],
                **{f"flash_bwd_{k}": fa.launches_bwd_by_variant[k] - by0[k]
                   for k in by0},
                **{f"flash_bwd_group{g}": n
                   for g, n in bwd_group_launches(group0).items()},
                "flash_bwd_windowed": fa.launches_bwd_windowed - windowed0}
    micro = steps * TRAIN_BATCH // TRAIN_MICROBATCH
    layers = len(cfg.attn_positions)
    bwd = fa.bwd_variant(torch.bfloat16, cfg.head_dim)
    group = cfg.num_heads // cfg.num_kv_heads
    # the forward and its replay, then the backward, each microbatch
    expected = {**flash_launches(cfg, 2 * micro), "hot_embed": micro,
                **gmm_launches(cfg, TRAIN_MICROBATCH * TRAIN_SEQ, 2 * micro,
                               micro),
                "flash_bwd_dq": layers * micro,
                "flash_bwd_dkdv": layers * micro,
                **{f"flash_bwd_{k}": 2 * layers * micro if k == bwd else 0
                   for k in by0},
                **({f"flash_bwd_group{group}": 2 * layers * micro}
                   if layers else {}),
                "flash_bwd_windowed": 2 * layers * micro if cfg.window else 0}
    if launches != expected:
        raise AssertionError(f"training launches {launches}, expected "
                             f"{expected}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    half = max(1, steps // 2)
    if not np.mean(losses[-half:]) < np.mean(losses[:half]):
        raise AssertionError(f"training loss does not fall: {losses}")
    per_step = {k: v // steps for k, v in launches.items()}
    print(f"train [{cfg.name}]: {steps} steps of {TRAIN_BATCH}x"
          f"{TRAIN_SEQ} positions ({cfg.prefix_tokens} of them a prefix), "
          f"losses {[round(x, 4) for x in losses]}, the "
          f"last {half}'s mean {np.mean(losses[-half:]):.4f} below the first "
          f"{half}'s {np.mean(losses[:half]):.4f}; launches a step "
          f"{per_step}")
    profile = profile_train_step(
        step, model, opt, with_prefix(cfg, batches[-1][:profile_rows], dev),
        float(np.mean([r["seconds"] for r in rows])))
    profile["microbatches"] = profile_rows // TRAIN_MICROBATCH
    del model, opt
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": rows, "profile": profile,
            "layer0": layer0, "params": n_params,
            "peak_gib": max(r["peak_gib"] for r in rows)}


# the port's hand-written kernels, by (a part of) their function names
PORT_KERNELS = ("csr_spmv_merge", "csr_spmv_carries", "hot_gather",
                "flash_fwd_bf16_wgmma", "flash_fwd_bf16_mma",
                "flash_fwd_f32_simt", "flash_bwd_dq_wgmma",
                "flash_bwd_dkdv_wgmma", "flash_bwd_dq_bf16",
                "flash_bwd_dkdv_bf16", "gmm_bf16_wgmma", "gmm_bf16_splitk",
                "gmm_bf16_tgmm", "gmm_f32_simt")


def profile_train_step(step, model, opt, batch, step_s: float) -> dict:
    """``torch.profiler`` over one more full-depth training step (after
    the timed ones and their launch counts): the device's busy time (the
    union of the device operations' spans) against the profiled step's
    wall and against ``step_s``, the timed steps' mean, the ten device
    operations that take the most time, summed by name, and the port's
    hand-written kernels among the operations (`PORT_KERNELS`): each
    one's ms and launches, wherever it ranks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t_prof = time.perf_counter()
    # the device's activity alone (the host's ops, some 10^5 of them, take
    # long to record and parse)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = device_events(prof)
    if not ops:
        raise AssertionError("train profile: the profiler recorded no "
                             "device operation")
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((start, stop) for _, start, stop in ops):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name: dict = {}
    ours: dict = {}
    for name, start, stop in ops:
        by_name[name] = by_name.get(name, 0.0) + stop - start
        kernel = next((k for k in PORT_KERNELS if k in name), None)
        if kernel is not None:
            ms, count = ours.get(kernel, (0.0, 0))
            ours[kernel] = (ms + (stop - start) / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"train profile: one step, wall {wall:.3f} s under the profiler "
          f"(timed steps {step_s:.3f} s), device busy {busy_us / 1e6:.3f} s "
          f"({100 * busy_us / 1e6 / wall:.1f}% of the profiled wall, "
          f"{100 * busy_us / 1e6 / step_s:.1f}% of a timed step), "
          f"{len(ops)} device ops; profiling took "
          f"{time.perf_counter() - t_prof:.1f} s")
    for name, us in top:
        print(f"train profile:   {us / 1e3:9.3f} ms  "
              f"{100 * us / busy_us:5.1f}%  {name[:90]}")
    for kernel, (ms, count) in sorted(ours.items()):
        print(f"train profile: the port's {kernel}: {ms:.3f} ms, {count} "
              f"launches, {100 * ms * 1e3 / busy_us:.1f}%")
    return {"wall_s": wall, "busy_s": busy_us / 1e6, "device_ops": len(ops),
            "top": [{"name": n[:120], "ms": us / 1e3} for n, us in top],
            "port_kernels": {k: {"ms": ms, "launches": count}
                             for k, (ms, count) in ours.items()}}


def loss_and_grads(model, batch, tape=None) -> tuple[float, dict]:
    """One microbatch's loss and every leaf's gradient (float32, on the
    CPU) of ``model`` on ``batch`` (on the model's device), inside
    ``tape`` (a `models.moe.RouteTape`) if one is given; the parameters
    are frozen again after."""
    import torch
    from repro_torch.models.transformer import loss_fn
    for p in model.parameters():
        p.requires_grad_(True)
    try:
        with tape if tape is not None else contextlib.nullcontext():
            loss, _ = loss_fn(model, batch)
            loss.backward()
        grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    finally:
        for p in model.parameters():
            p.grad = None
            p.requires_grad_(False)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return float(loss.detach()), grads


def leaf_errors(got, want) -> dict:
    """Each leaf's relative L2 error of ``got`` against ``want``."""
    return {n: float((got[n] - want[n]).norm()
                     / want[n].norm().clamp(min=1e-30)) for n in want}


def hold_grads(label: str, got, want, got_loss, want_loss) -> tuple:
    """The card's loss within 1e-2 relative of the CPU's and each leaf's
    relative L2 error within 5e-2, no leaf all zero on the card. Returns
    (worst leaf, its error, every leaf's error by name)."""
    if abs(got_loss - want_loss) > 1e-2 * abs(want_loss):
        raise AssertionError(f"{label}: loss {got_loss} against {want_loss}")
    zero = [n for n in got if not bool(got[n].any())]
    if zero:
        raise AssertionError(f"{label}: gradient leaves all zero {zero[:8]}")
    rel = leaf_errors(got, want)
    worst = max(rel, key=rel.get)
    if rel[worst] > 5e-2:
        raise AssertionError(f"{label}: {worst}'s gradient parts by "
                             f"{rel[worst]:.3e} (relative L2)")
    return worst, rel[worst], rel


@contextlib.contextmanager
def compute_dtype(dtype):
    """The model modules' ``COMPUTE_DTYPE`` set to ``dtype`` inside."""
    from repro_torch.models import layers, mamba2, rwkv6, transformer
    mods = (layers, mamba2, rwkv6, transformer)
    kept = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, kept):
            m.COMPUTE_DTYPE = d


def print_decay(label: str, rel: dict) -> None:
    """The decay path's leaves (`DECAY_LEAVES`) by name with their errors."""
    decay = {n: e for n, e in rel.items()
             if n.rsplit(".", 1)[-1] in DECAY_LEAVES}
    if decay:
        print(f"{label}: the decay path, relative L2: "
              + ", ".join(f"{n} {e:.3e}" for n, e in decay.items()))


def train_card_vs_cpu(dev, arch: str, host, layers: int = 2) -> None:
    """One microbatch's loss and gradients, ``arch``'s width cut to
    ``layers`` layers, 1 x 512 positions (`lm_batch`: paligemma-3b's 256
    prefix rows from N(0, 1) and 256 tokens), the same weights on the CPU
    (``host``, a future of `host_grads` from the pool: plain versions, p
    rounded to bf16 before PV as the reference does) and the card
    (kernels, PV in float32; both drawn by `draw_weights`), both runs
    computing in `grad_dtype`: the
    loss within 1e-2 relative, each leaf's relative L2 error within 5e-2
    (`hold_grads`); the decay path's leaves printed by name. Then on the
    card remat on (the config's) against off over the same parameters, in
    bf16: every gradient equal bit for bit."""
    import dataclasses
    import torch
    from repro_torch.models.transformer import Transformer, param_tree

    cfg = grad_cut(arch, layers)
    if not cfg.remat:
        raise AssertionError(f"{cfg.name} trains with remat")
    dtype = getattr(torch, grad_dtype(arch, layers))
    label = f"train card vs CPU [{cfg.name}, depth {layers}, {dtype}]"
    card = draw_weights(cfg, dev)
    batch = lm_batch(cfg, token_source(cfg, 512), 1, 512)
    cpu = host_result(host, label, card)
    same_batch(label, cpu["batch"], batch)
    want_loss, want = cpu["loss"], cpu["grads"]
    with compute_dtype(dtype):
        got_loss, got = loss_and_grads(card, on(dev, batch))
    worst, err, rel = hold_grads(label, got, want, got_loss, want_loss)
    print(f"{label}, 1x512 positions: loss {got_loss:.6f} against "
          f"{want_loss:.6f}; the worst leaf {worst} at {err:.3e} relative "
          f"L2, {len(rel)} leaves")
    print_decay(label, rel)
    if dtype != torch.bfloat16:
        _, got = loss_and_grads(card, on(dev, batch))
    del want, cpu
    plain = Transformer(dataclasses.replace(cfg, remat=False),
                        param_tree(card))
    _, off = loss_and_grads(plain, on(dev, batch))
    differ = [n for n in got if not torch.equal(got[n], off[n])]
    if differ:
        raise AssertionError(f"{cfg.name}: remat on and off give other "
                             f"gradient bits: {differ[:8]}")
    print(f"train remat bits [{cfg.name}, depth {layers}]: all "
          f"{len(got)} gradient leaves equal bit for bit on the card with "
          f"remat on and off")
    del card, plain, got, off
    torch.cuda.empty_cache()


def train_prefix_run(dev) -> None:
    """paligemma-3b through ``launch.train.main`` on the card, full width
    cut to 2 layers (``--depth 2``), 3 steps of 2 x 320 positions: the
    trainer's own prefix batch (256 rows of zero embeddings before 64
    tokens), finite losses, each step's attention backward on the
    ``wgmma`` pair (one of each kernel a layer a step). It saves no
    checkpoint (``--no-final-ckpt``): nothing restores this run."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.kernels.flash_attn import flash_attn as fa
    from repro_torch.launch.train import main as train_main
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    by0 = dict(fa.launches_bwd_by_variant)
    try:
        losses = train_main(["--arch", PREFIX_ARCH, "--depth", "2",
                             "--seq-len", "320", "--global-batch", "2",
                             "--steps", "3", "--ckpt-dir", tmp,
                             "--ckpt-every", "0", "--no-final-ckpt",
                             "--no-vocab-reorder",
                             "--log-every", "1", "--device", str(dev)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = {k: fa.launches_bwd_by_variant[k] - by0[k] for k in by0}
    if not np.all(np.isfinite(losses)) or launched != {
            "wgmma": 2 * 2 * 3, "mma_sync": 0}:
        raise AssertionError(f"train main [{PREFIX_ARCH} --depth 2]: losses "
                             f"{losses}, backward launches {launched}")
    print(f"train main [{PREFIX_ARCH} --depth 2 --seq-len 320]: losses "
          f"{[round(x, 5) for x in losses]}, backward launches {launched}")


def train_resume(dev, arch: str, cut: list) -> None:
    """tests/test_system.py::test_train_resume_continues through
    ``launch.train.main`` on the card, ``arch`` cut by ``cut`` (zamba2-1.2b:
    ``--depth 2``, its full width; mixtral-8x7b: ``--smoke``, since a
    full-width save of even one of its layers is about 20 GB): steps 0-9
    straight, then 0-4 with a periodic save at
    step 4, a "crash", and ``--resume`` for 5-9, all with
    ``--total-steps 10``; the first five losses of two runs at rtol 1e-5,
    the resumed ones at rtol/atol 5e-3. Only the crashed run saves, once,
    at step 4 (``--ckpt-every 5``, the trainer's asynchronous periodic
    save), the one checkpoint the resume reads: every run passes
    ``--no-final-ckpt``, since a depth-2 save of rwkv6-3b is 6.1 GB,
    about 10 s, and no closing save is ever restored. The checkpoint
    goes to a temporary directory, deleted after."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.launch.train import main as train_main
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    args = ["--arch", arch, *cut, "--seq-len", "32", "--global-batch", "2",
            "--ckpt-dir", tmp, "--total-steps", "10", "--no-vocab-reorder",
            "--no-final-ckpt", "--log-every", "100", "--device", str(dev)]
    try:
        full = train_main(["--steps", "10", "--ckpt-every", "0"] + args)
        if any(pathlib.Path(tmp).iterdir()):
            raise AssertionError("--no-final-ckpt: the straight run saved")
        part = train_main(["--steps", "5", "--ckpt-every", "5"] + args)
        cont = train_main(["--steps", "10", "--resume", "--ckpt-every", "0"]
                          + args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    np.testing.assert_allclose(part[:5], full[:5], rtol=1e-5)
    np.testing.assert_allclose(cont, full[5:], rtol=5e-3, atol=5e-3)
    print(f"train resume [{arch} {' '.join(cut)}]: losses 5-9 straight "
          f"{[round(x, 5) for x in full[5:]]}, resumed "
          f"{[round(x, 5) for x in cont]}")


# ------------------------------------------------ phase 14: MoE training
def tgmm_check(name, x, dy, offs, verbose: bool = True) -> float:
    """The weight-gradient kernel against its plain version on the same
    card tensors: the float32 result at GMM_TOL (exact bf16 products
    summed in another order), the bf16 result equal to it rounded once, a
    repeat's bits equal, groups with no rows zero. Returns max |err|."""
    import torch
    from repro_torch.kernels.moe_gmm import moe_gmm as gm
    from repro_torch.kernels.moe_gmm.ref import tgmm_grouped_ref
    got = gm.tgmm(x, dy, offs)
    again = gm.tgmm(x, dy, offs)
    half = gm.tgmm(x, dy, offs, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"tgmm[{name}]: two runs differ")
    want = tgmm_grouped_ref(x, dy, offs)
    torch.testing.assert_close(got, want, **GMM_TOL)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(half, got.to(torch.bfloat16)):
        raise AssertionError(f"tgmm[{name}]: the bf16 result is not the "
                             f"float32 one rounded")
    sizes = (offs[1:] - offs[:-1]).tolist()
    empty = [g for g, c in enumerate(sizes) if c <= 0]
    if empty and got[empty].any():
        raise AssertionError(f"tgmm[{name}]: a group with no rows is not "
                             f"zero")
    if verbose:
        print(f"tgmm[{name}]: M={x.shape[0]} K={x.shape[1]} N={dy.shape[1]} "
              f"E={len(sizes)} rows={min(int(offs[-1]), x.shape[0])} empty "
              f"groups={len(empty)}; max_abs_err {err:.3e} (largest |dW| "
              f"{float(want.abs().max()):.3e})")
    return err


def dx_check(name, x, w, dy, offs) -> float:
    """`ragged_dot`'s backward through its autograd Function on the card:
    dX is the `gmm` kernel's float32 sum over the expert stack read
    transposed, rounded once (held to the plain version at GMM_TOL), dW
    the `tgmm` kernel's; a repeat gives the same bits. Returns dX's max
    |err|."""
    import torch
    from repro_torch.kernels.moe_gmm import moe_gmm as gm
    from repro_torch.kernels.moe_gmm.ops import ragged_dot
    from repro_torch.kernels.moe_gmm.ref import gmm_grouped_ref
    sizes = offs[1:] - offs[:-1]
    grads = []
    for _ in range(2):
        a = x.clone().requires_grad_(True)
        b = w.clone().requires_grad_(True)
        ragged_dot(a, b, sizes).backward(dy)
        grads.append((a.grad, b.grad))
    torch.cuda.synchronize()
    (dx, dw), (dx2, dw2) = grads
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError(f"ragged_dot backward[{name}]: two runs differ")
    dx32 = gm.gmm(dy, w, offs, out_dtype=torch.float32, w_transposed=True)
    want = gmm_grouped_ref(dy, w.transpose(1, 2), offs)
    torch.testing.assert_close(dx32, want, **GMM_TOL)
    if not torch.equal(dx, dx32.to(torch.bfloat16)):
        raise AssertionError(f"ragged_dot backward[{name}]: dX is not the "
                             f"kernel's float32 sum rounded once")
    if not torch.equal(dw, gm.tgmm(x, dy, offs, out_dtype=torch.bfloat16)):
        raise AssertionError(f"ragged_dot backward[{name}]: dW is not the "
                             f"tgmm kernel's")
    err = float((dx32 - want).abs().max())
    print(f"ragged_dot backward[{name}]: dX through gmm (wgmma, the stack "
          f"read transposed) max_abs_err {err:.3e}, dW through tgmm, bits "
          f"repeat")
    return err


def tgmm_kernel_cases(dev) -> float:
    """`tgmm` against its plain version at the smoke (64/128), served
    (2048/1408 and 1408/2048) and K 136 / N 200 widths and at M 333 (not
    a multiple of 128), with empty groups, one group holding every row,
    rows past the groups' total, and only two groups holding rows; then
    dX and dW through `ragged_dot`'s Function at two of them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 14)

    def normal(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dev, torch.bfloat16)

    err = 0.0
    for m, k, n, e in ((40, 64, 128, 4), (40, 128, 64, 4),
                       (1000, 2048, 1408, 64), (1000, 1408, 2048, 64),
                       (333, 2048, 1408, 64), (228, 136, 200, 3)):
        x, dy = normal((m, k)), normal((m, n))
        for case in ("skewed", "one_group", "short", "two_groups"):
            sizes = np.zeros(e, np.int64)
            if case == "one_group":
                sizes[e // 2] = m
            elif case == "short":            # rows past the total
                sizes[:] = rng.multinomial(m - 13, np.ones(e) / e)
            elif case == "two_groups":       # every other group empty
                sizes[[0, e - 1]] = [m // 3, m - m // 3]
            else:                            # skewed, with empty groups
                pz = 1.0 / (1 + np.arange(e)) ** 1.2
                sizes[:] = rng.multinomial(m, pz / pz.sum())
                sizes[1] = 0
            offs = torch.from_numpy(np.concatenate(
                [[0], np.cumsum(sizes)]).astype(np.int32)).to(dev)
            err = max(err, tgmm_check(f"{case}", x, dy, offs))
            if case == "skewed" and k in (2048, 136):
                w = normal((e, k, n), k ** -0.5)
                err = max(err, dx_check(f"{case} {m}x{k}x{n}", x, w, dy,
                                        offs))
    return err


def time_tgmm(layer0: dict) -> dict:
    """`tgmm` at a training microbatch's shapes (layer 0's real rows and
    dY, kept from the first microbatch's backward): the gate product's
    weight gradient (moonshot: xᵀ (2048 x 49,152) @ dY (49,152 x 1408)
    over 64 groups; mixtral-8x7b: xᵀ (4096 x 16,384) @ dY (16,384 x
    14,336) over 8) and the down product's (its transpose widths), each
    beside
    its plain version, the bound (operations at the bf16 rate, bytes at
    HBM's: x and dY read once, dW written once) and one PyTorch call as a
    yardstick, ``torch._grouped_mm(xᵀ, dY, offs=)`` (timed only; the port
    never calls it); then dX through `gmm` reading the expert stack
    transposed, beside a transposed copy of the stack and `gmm` on it
    (the copy and the kernel apart)."""
    import torch
    from repro_torch.kernels.moe_gmm import moe_gmm as gm
    from repro_torch.kernels.moe_gmm.ref import tgmm_grouped_ref
    kept = gm.launches, dict(gm.launches_by_variant)
    bf16 = torch.bfloat16
    out = {}
    for name, (x, dy, offs), w in (("gate", layer0["gate"], layer0["w_gate"]),
                                   ("down", layer0["down"],
                                    layer0["w_down"])):
        m, k = x.shape
        n, e = dy.shape[1], offs.shape[0] - 1
        rows = min(int(offs[-1]), m)
        flops = 2 * rows * k * n
        nbytes = 2 * rows * (k + n) + 2 * e * k * n + 4 * (e + 1)
        ops_ms = flops / BF16_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ends = offs[1:]
        row = {"ms": cuda_ms(lambda: gm.tgmm(x, dy, offs, out_dtype=bf16),
                             reps=20),
               "plain_ms": cuda_ms(lambda: tgmm_grouped_ref(x, dy, offs, bf16),
                                   reps=2, warmup=1),
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "library_ms": cuda_ms(
                   lambda: torch._grouped_mm(x.t(), dy, offs=ends), reps=20),
               "shape": f"xT ({k} x {rows}) @ dY ({rows} x {n}), {e} groups"}
        print(f"tgmm timing [{name}]: {row['shape']}: ms={row['ms']:.4f} "
              f"({flops / row['ms'] / 1e9:.1f} TFLOP/s, "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound) "
              f"plain_ms={row['plain_ms']:.4f} library_ms="
              f"{row['library_ms']:.4f} (torch._grouped_mm(xT, dY, offs=)) "
              f"bound_ms={row['bound_ms']:.4f} ({flops:.4e} FLOPs, {ops_ms:.4f}"
              f" ms at the bf16 rate; {nbytes} bytes, {bytes_ms:.4f} ms at "
              f"HBM's)")
        wt = w.transpose(1, 2).contiguous()
        dx_ms = cuda_ms(lambda: gm.gmm(dy, w, offs, out_dtype=bf16,
                                       w_transposed=True), reps=20)
        copy_ms = cuda_ms(lambda: w.transpose(1, 2).contiguous(), reps=20)
        kernel_ms = cuda_ms(lambda: gm.gmm(dy, wt, offs, out_dtype=bf16),
                            reps=20)
        # dX reads dY and the used experts' weights, writes (M, K)
        used = int(((offs[1:] - offs[:-1]) > 0).sum())
        dx_bytes = 2 * rows * n + 2 * used * k * n + 2 * m * k + 4 * (e + 1)
        dx_bound = max(ops_ms, dx_bytes / HBM_BYTES_PER_S * 1e3)
        row["dx"] = {"ms": dx_ms, "bound_ms": dx_bound, "copy_ms": copy_ms,
                     "gmm_on_copy_ms": kernel_ms}
        print(f"dX timing [{name}]: gmm(dY ({rows} x {n}), w[e]T of the ({e} "
              f"x {k} x {n}) stack) {dx_ms:.4f} ms (wgmma reading it "
              f"transposed; {flops / dx_ms / 1e9:.1f} TFLOP/s, bound "
              f"{dx_bound:.4f}); a transposed copy instead {copy_ms:.4f} ms "
              f"({2 * e * k * n} bytes) plus gmm on it {kernel_ms:.4f} ms")
        out[name] = row
        del wt
    gm.launches, gm.launches_by_variant = kept   # not the main path's
    return out


def moe_train_card_vs_cpu(dev, host, arch: str = MOE_ARCH,
                          layers: int = MOE_GRAD_LAYERS) -> dict:
    """An MoE's width (moonshot's, mixtral-8x7b's) cut to ``layers``
    layers, 1 x 512 tokens,
    remat on in both runs (the config's own setting): one microbatch's
    loss and gradients on the CPU (``host``, a future of `host_grads` from
    the pool: plain versions) and on the card (kernels), the card
    replaying the CPU's expert choices (`models.moe.RouteTape`: with
    remat each run routes a layer in the forward and again in the
    backward's replay, in the same order), at `hold_grads`'s standard.
    Then the card's own routing, remat on and off over the same
    parameters: the replay routes as the forward did, and every gradient
    is equal bit for bit."""
    import dataclasses
    import torch
    from repro_torch.models.moe import RouteTape
    from repro_torch.models.transformer import Transformer, param_tree

    cfg = grad_cut(arch, layers)
    if not cfg.remat:
        raise AssertionError(f"{cfg.name} trains with remat")
    label = f"MoE train card vs CPU [{cfg.name}, depth {layers}]"
    card = draw_weights(cfg, dev)
    batch = lm_batch(cfg, token_source(cfg, 512), 1, 512)
    cpu = host_result(host, label, card)
    same_batch(label, cpu["batch"], batch)
    want_loss, want, experts = cpu["loss"], cpu["grads"], cpu["experts"]
    del cpu
    tokens = batch["tokens"]
    batch = {"tokens": tokens.to(dev)}
    if len(experts) != 2 * layers:
        raise AssertionError(f"{len(experts)} routing calls with remat "
                             f"at {layers} layers")
    got_loss, got = loss_and_grads(card, batch, RouteTape(experts))
    worst, err, rel = hold_grads(label, got, want, got_loss, want_loss)
    print(f"train card vs CPU [{cfg.name}], {layers} layers at full width, "
          f"1x512 tokens, remat on, the CPU's routing replayed: loss "
          f"{got_loss:.6f} against {want_loss:.6f}; the worst leaf {worst} "
          f"at {err:.3e} relative L2, {len(rel)} leaves, none all zero")
    del want, got

    on_tape, off_tape = RouteTape(), RouteTape()
    _, on = loss_and_grads(card, batch, on_tape)
    plain = Transformer(dataclasses.replace(cfg, remat=False),
                        param_tree(card))
    _, off = loss_and_grads(plain, batch, off_tape)
    fwd, replay = on_tape.experts[:layers], on_tape.experts[layers:]
    if not (len(replay) == len(off_tape.experts) == layers and all(
            torch.equal(a, b) for a, b in zip(fwd, replay[::-1])) and all(
            torch.equal(a, b) for a, b in zip(fwd, off_tape.experts))):
        raise AssertionError(f"{cfg.name}: the remat replay routed "
                             f"otherwise")
    differ = [n for n in on if not torch.equal(on[n], off[n])]
    if differ:
        raise AssertionError(f"{cfg.name}: remat on and off give other "
                             f"gradient bits: {differ[:8]}")
    parted = sum(int((a != b).any(-1).sum())
                 for a, b in zip(fwd, experts[:layers]))
    print(f"train remat bits [{cfg.name}]: {layers} layers on the card, its "
          f"own routing (replay = forward at every layer; {parted} of "
          f"{layers * tokens.numel()} token choices part from the CPU's), "
          f"all {len(on)} gradient leaves equal bit for bit with remat on "
          f"and off")
    del card, plain, on, off
    torch.cuda.empty_cache()
    return {"worst_rel_l2": err}


def ckpt_round_trip(dev) -> None:
    """An MoE's checkpoint tree on the card (tests/test_torch_ckpt.py:46
    on the CPU): smoke moonshot after one train step, its params and
    AdamW moments through `launch.train.train_state` (the reference's
    stacked layout on the host), `CheckpointManager` save and restore,
    and `load_state` back onto the card, every leaf bit for bit."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import load_state, train_state
    from repro_torch.models.transformer import (init_params, param_tree,
                                                stack_layers, to_jax_params)
    from repro_torch.train.optim import TrainConfig, init_opt_state
    from repro_torch.train.steps import make_train_step
    cfg = smoke_config(MOE_ARCH, layers=2)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    opt = init_opt_state(param_tree(model))
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(SEED))
    model, opt, _ = make_train_step(cfg, TrainConfig(warmup_steps=0))(
        model, opt, {"tokens": tokens.to(dev)})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        CheckpointManager(tmp).save(3, train_state(model, opt),
                                    blocking=True)
        step, state = CheckpointManager(tmp).restore()
    back, opt2 = load_state(cfg, state, dev)

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return np.array_equal(a, b)
    if step != 3 or int(opt2["step"]) != int(opt["step"]) or not (
            same(to_jax_params(back), to_jax_params(model))
            and same(stack_layers(opt2["mu"]), stack_layers(opt["mu"]))
            and same(stack_layers(opt2["nu"]), stack_layers(opt["nu"]))):
        raise AssertionError("the MoE checkpoint does not round-trip")
    print(f"checkpoint round trip [{cfg.name} smoke, on {dev}]: every "
          f"param and AdamW moment (the experts' stacks and the router "
          f"included) bit for bit")


def moe_train_phase(dev, host: GradJobs) -> dict:
    """Phase 14's MoE part, after qwen2.5-3b's model is freed: `tgmm`
    checked on the card, moonshot trained at full width and
    `MOE_TRAIN_LAYERS` layers, `tgmm` and dX checked on layer 0's real
    rows and timed there, the card's gradients against the CPU's and
    remat's bits, and a checkpoint round trip. ``host`` holds the futures
    of the CPU's halves (`GRAD_CHECKS`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    t0 = time.perf_counter()
    err = tgmm_kernel_cases(dev)
    run = train_full_width(dev, cut_depth(get_config(MOE_ARCH),
                                          MOE_TRAIN_LAYERS))
    layer0 = run.pop("layer0")
    for name, w in (("gate", layer0["w_gate"]), ("down", layer0["w_down"])):
        x, dy, offs = layer0[name]
        err = max(err, tgmm_check(f"layer0 train {name}", x, dy, offs),
                  dx_check(f"layer0 train {name}", x, w, dy, offs))
    run["timing"] = time_tgmm(layer0)
    del layer0
    run["card_vs_cpu"] = moe_train_card_vs_cpu(
        dev, host[MOE_ARCH, MOE_GRAD_LAYERS])
    ckpt_round_trip(dev)
    run["err"] = err
    print(f"phase 14 [{MOE_ARCH}]: {time.perf_counter() - t0:.1f} s wall")
    return run


def wide_train_phase(dev, host: GradJobs) -> dict:
    """Phase 14's part for the configs phase 13 serves last, after
    moonshot's: chatglm3-6b (group 16, half rotary, q/k/v biases),
    starcoder2-7b (group 9, layernorm, biased GELU MLP) and mixtral-8x7b
    (group 4, window 4,096, 8 experts of 14,336), each at full width and
    its depth cut `TRAIN_DEPTH`, through `train_full_width`
    (`RECURRENT_TRAIN_STEPS` steps and a profiled step of one
    microbatch; the depth printed as a
    cut with the parameters and the peak); for mixtral `tgmm` and dX held
    to their plain versions on layer 0's real rows and timed there; each
    one's card against the CPU at `WIDE_GRAD_LAYERS` with remat's bits
    (`train_card_vs_cpu`, mixtral's on the CPU's replayed routing,
    `moe_train_card_vs_cpu`); and a resume through ``launch.train.main``
    on smoke mixtral (a full-width save of one of its layers is about 20
    GB). Returns each arch's run by name."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    out = {}
    for arch, depth in TRAIN_DEPTH.items():
        t0 = time.perf_counter()
        full = get_config(arch)
        run = train_full_width(dev, cut_depth(full, depth),
                               RECURRENT_TRAIN_STEPS, TRAIN_MICROBATCH)
        print(f"train [{arch}]: depth cut to {depth} of {full.num_layers} "
              f"layers at full width, {run['params']} parameters, peak "
              f"{run['peak_gib']:.1f} GiB")
        layer0 = run.pop("layer0")
        if layer0 is not None:
            err = 0.0
            for name in ("gate", "down"):
                x, dy, offs = layer0[name]
                err = max(err, tgmm_check(f"{arch} layer0 train {name}", x,
                                          dy, offs),
                          dx_check(f"{arch} layer0 train {name}", x,
                                   layer0[f"w_{name}"], dy, offs))
            run.update(err=err, timing=time_tgmm(layer0))
            del layer0
        layers = WIDE_GRAD_LAYERS[arch]
        if full.is_moe:
            run["card_vs_cpu"] = moe_train_card_vs_cpu(
                dev, host[arch, layers], arch, layers)
        else:
            train_card_vs_cpu(dev, arch, host[arch, layers], layers)
        print(f"phase 14 [{arch}]: {time.perf_counter() - t0:.1f} s wall")
        out[arch] = run
    timed("14 [resume]", train_resume, dev, SWA_ARCH, ["--smoke"])
    return out


def prefix_train_phase(dev, host: GradJobs) -> dict:
    """Phase 14's prefix-LM part, after qwen2.5-3b's model is freed:
    paligemma-3b (d 256, 8 heads over 1 kv head, a 256-row prefix) trained
    at full width and depth for `TRAIN_STEPS` steps, its card's
    gradients held to the CPU's at 2 layers with remat's bits, and
    ``launch.train.main``'s own prefix batch."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    run = train_full_width(dev, get_config(PREFIX_ARCH))
    run.pop("layer0")
    train_card_vs_cpu(dev, PREFIX_ARCH, host[PREFIX_ARCH, 2])
    train_prefix_run(dev)
    print(f"phase 14 [{PREFIX_ARCH}]: {time.perf_counter() - t0:.1f} s wall")
    return run


def recurrent_train_phase(dev, host: GradJobs) -> dict:
    """Phase 14's recurrent part, after moonshot's: rwkv6-3b and
    zamba2-1.2b each trained at full width and depth for
    `RECURRENT_TRAIN_STEPS` steps and a profiled step of one microbatch
    (`train_full_width`: the scans' backward
    through their chunked forms and state loops, zamba2's shared block
    through the flash backward, the token embedding through the hot
    slab), its card's gradients held to the CPU's at 2 layers with remat's
    bits and the decay path by name (`train_card_vs_cpu`; zamba2's cut
    keeps its shared block; rwkv6-3b's in float32, then in bf16 at 1
    layer), and zamba2's resume through ``launch.train.main`` at
    ``--depth 2``. Returns each arch's run by name."""
    from repro_torch.configs import get_config
    out = {}
    for arch in (RWKV_ARCH, HYBRID_ARCH):
        t0 = time.perf_counter()
        run = train_full_width(dev, get_config(arch), RECURRENT_TRAIN_STEPS,
                               TRAIN_MICROBATCH)
        run.pop("layer0")
        train_card_vs_cpu(dev, arch, host[arch, 2])
        if arch in F32_GRAD_ARCHS:
            train_card_vs_cpu(dev, arch, host[arch, 1], 1)
        if arch == HYBRID_ARCH:     # phase 14's one full-width resume
            timed("14 [resume]", train_resume, dev, arch, ["--depth", "2"])
        print(f"phase 14 [{arch}]: {time.perf_counter() - t0:.1f} s wall")
        out[arch] = run
    return out


def train_phase(dev, pool: HostPool) -> dict:
    """Phase 14: training. The CPU's halves of its card-against-CPU checks
    submitted to ``pool`` (`GradJobs`), then the backward kernels
    checked (`BWD_SHAPES`) and timed (`BWD_TIMING`: mixtral's window at S
    16,384 must take clearly less than the same call without it), then
    qwen2.5-3b trained at full width and depth, the card's gradients held
    to the CPU's; then paligemma-3b the same way (`prefix_train_phase`);
    then moonshot-v1-16b-a3b's MoE (`moe_train_phase`); then chatglm3-6b,
    starcoder2-7b and mixtral-8x7b (`wide_train_phase`); then the
    recurrent trunks (`recurrent_train_phase`). Each part prints its
    wall."""
    from repro_torch.configs import get_config
    host = GradJobs(pool)

    def checks():
        return max([flash_bwd_check(name, "wgmma", *shape, dev)
                    for name, shape in zip(BWD_NAMES, BWD_SHAPES)]
                   + [flash_bwd_check("qwen2.5-3b microbatch at d 32, GQA",
                                      "mma_sync", *BWD_MMA_SYNC_SHAPE, dev)])
    err = timed("14 [flash backward checks]", checks)
    timing = timed("14 [flash backward timing]",
                   lambda: [time_flash_bwd(*shape, dev)
                            for shape in BWD_TIMING])
    windowed, causal = timing[-2:]
    share = windowed["pairs_per_head"] / causal["pairs_per_head"]
    if not windowed["ms"] < 0.75 * causal["ms"]:
        raise AssertionError(
            f"the windowed backward at S 16,384 takes {windowed['ms']:.4f} "
            f"ms against {causal['ms']:.4f} without the window: its key "
            f"tiles left of the window are not skipped")
    print(f"flash backward: mixtral's window at S 16,384 lets {share:.3f} "
          f"of the causal pairs through and takes "
          f"{windowed['ms'] / causal['ms']:.3f} of the causal time "
          f"({windowed['ms']:.4f} against {causal['ms']:.4f} ms)")
    t0 = time.perf_counter()
    run = train_full_width(dev, get_config(TRAIN_ARCH))
    run.pop("layer0")
    train_card_vs_cpu(dev, TRAIN_ARCH, host[TRAIN_ARCH, 2])
    print(f"phase 14 [{TRAIN_ARCH}]: {time.perf_counter() - t0:.1f} s wall")
    pali = prefix_train_phase(dev, host)
    moe = moe_train_phase(dev, host)
    wide = wide_train_phase(dev, host)
    recurrent = recurrent_train_phase(dev, host)
    parts = (run["launches"], pali["launches"], moe["launches"],
             *(r["launches"] for r in wide.values()),
             *(r["launches"] for r in recurrent.values()))
    launches = {k: sum(x.get(k, 0) for x in parts)
                for k in set().union(*parts)}
    return {"err": err, "timing": timing, **run, "launches": launches,
            "prefix": pali, "moe": moe, "wide": wide,
            "recurrent": recurrent}


# ------------------------------------------------------ phase 15: the mesh
def bwd_snapshot() -> tuple:
    from repro_torch.kernels.flash_attn import flash_attn as fa
    return dict(fa.launches_bwd), dict(fa.launches_bwd_by_variant)


def bwd_delta(since: tuple) -> dict:
    """The flash backward's launches since `bwd_snapshot`, by kernel and
    by variant, as phase 14 books them."""
    from repro_torch.kernels.flash_attn import flash_attn as fa
    by, var = since
    return {"flash_bwd_dq": fa.launches_bwd["dq"] - by["dq"],
            "flash_bwd_dkdv": fa.launches_bwd["dkdv"] - by["dkdv"],
            **{f"flash_bwd_{k}": fa.launches_bwd_by_variant[k] - var[k]
               for k in var}}


def mesh_of(shape):
    """A ``(data, model)`` mesh of ``shape``, every shard on ``cuda:0`` (the
    run needs one card; NCCL refuses two ranks on one card, and the port's
    mesh is single-controller)."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, MESH_AXES, "cuda:0")


def shard_bytes(trees) -> list:
    """Bytes each shard holds of the `ShardedTensor` leaves of ``trees``."""
    from repro_torch.train.optim import _leaves
    out = None
    for tree in trees:
        for _, st in _leaves(tree):
            b = [t.numel() * t.element_size() for t in st.shards]
            out = b if out is None else [x + y for x, y in zip(out, b)]
    return out


def hold_chunked(name, got, want, rows: int = 2048) -> dict:
    """``got`` against ``want`` ((1, n, V) bf16) at `hold_logits`'s
    standard (DECODE_TOL, argmax agreement > 0.95 with ties within one
    bf16 unit), ``rows`` positions at a time in float32."""
    import torch
    worst, agree, same, n = 0.0, 0.0, 0.0, got.shape[1]
    for a in range(0, n, rows):
        g, w = got[:, a:a + rows].float(), want[:, a:a + rows].float()
        torch.testing.assert_close(g, w, **DECODE_TOL)
        worst = max(worst, float((g - w).abs().max()))
        best = w.amax(-1)
        picked = w.gather(-1, g.argmax(-1, keepdim=True))[..., 0]
        agree += float((best - picked <= bf16_unit(best)).float().sum())
        same += float((w.argmax(-1) == g.argmax(-1)).float().sum())
    agree, same = agree / (n * got.shape[0]), same / (n * got.shape[0])
    print(f"{name}: {got.shape[0]}x{n} positions, max_abs_diff {worst:.4f}, "
          f"argmax agreement {agree:.4f} ({same:.4f} the same token)")
    if agree <= 0.95:
        raise AssertionError(f"{name}: argmax agreement {agree}")
    return {"max_abs_diff": worst, "argmax_agreement": agree}


def drops_by_layer(tape, shards: int) -> list:
    """(rows kept, rows dropped) of each layer's dispatches in a
    `models.moe.DropTape` (one call a shard a layer, in layer order)."""
    out = []
    for a in range(0, len(tape.calls), shards):
        kept = sum(int(c[1].sum()) for c in tape.calls[a:a + shards])
        rows = sum(c[1].numel() for c in tape.calls[a:a + shards])
        out.append((kept, rows - kept))
    return out


def mesh_flash(cfg, mesh, calls: int) -> dict:
    """`flash_launches` of ``calls`` forwards on ``mesh``: one a layer a
    shard, grouped where a model shard's query heads outnumber the kv
    heads they read (qwen2.5-3b: 4 over 1 at model 4, 8 over 1 at 2)."""
    out = flash_launches(cfg, calls * mesh.size)
    nm = mesh.shape["model"]
    grouped = cfg.num_heads // nm > max(1, cfg.num_kv_heads // nm)
    out["flash_attn_gqa"] = out["flash_attn"] if grouped else 0
    return out


def mesh_launches(got: dict, want: dict, what: str) -> None:
    """``got``'s launch counts equal ``want``'s where ``want`` names them."""
    wrong = {k: (got.get(k, 0), v) for k, v in want.items()
             if got.get(k, 0) != v}
    if wrong:
        raise AssertionError(f"{what}: launches (got, expected) {wrong}")


def seqsharded_attention_check(dev, cfg, mesh) -> float:
    """`layers._decode_attn_seqsharded` alone at ``cfg``'s heads (qwen2.5-3b:
    2 kv heads of 8 query heads, head dim 128) over a `MESH_DECODE` cache
    split on its sequence over ``mesh``'s 4 model shards, against the
    unsharded decode attention (`layers._sdpa_chunked`, p in float32) over
    the same cache after the same write: within 1e-3 or one bf16 unit of
    each value (both round one float32 result to bf16), and the caches'
    slices equal the whole cache's. Returns the max abs difference."""
    import torch
    from repro_torch.launch.shardings import P, shard_leaf
    from repro_torch.models import layers as L
    b, t, filled = (MESH_DECODE[k] for k in ("batch", "cache", "filled"))
    kv, dh = cfg.num_kv_heads, cfg.head_dim
    rep = cfg.num_heads // kv
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, kn, vn = randn(b, 1, kv, rep, dh), randn(b, 1, kv, dh), randn(
        b, 1, kv, dh)
    ck, cv = randn(b, t, kv, dh), randn(b, t, kv, dh)
    length = torch.tensor(filled, dtype=torch.int32, device=dev)
    spec = P(None, "model", None, None)
    cache = {"k": shard_leaf(ck, spec, mesh), "v": shard_leaf(cv, spec, mesh),
             "length": shard_leaf(length, P(), mesh)}
    n = mesh.size
    got, new = L._decode_attn_seqsharded([q] * n, [kn] * n, [vn] * n, cache,
                                         cfg, mesh)
    pos = length[None]
    wk, wv, k_pos, k_valid = L._cache_write(
        {"k": ck, "v": cv, "length": length}, kn, vn, cfg, pos)
    want = L._sdpa_chunked(q.reshape(b, 1, kv * rep, dh), wk, wv, pos, k_pos,
                           cfg, k_valid, round_p=False).float()
    err = 0.0
    for o in got:
        o = o.reshape(want.shape).float()
        d = (o - want).abs()
        if not bool((d <= torch.clamp(bf16_unit(want), min=1e-3)).all()):
            raise AssertionError(f"sequence-sharded decode attention parts "
                                 f"from the unsharded by {float(d.max())}")
        err = max(err, float(d.max()))
    if not (torch.equal(new["k"].full(), wk) and torch.equal(
            new["v"].full(), wv) and all(
            int(x) == filled + 1 for x in new["length"].shards)):
        raise AssertionError("the sequence-sharded write is not the whole "
                             "cache's")
    print(f"mesh: _decode_attn_seqsharded at {b}x{t} positions ({filled} "
          f"filled), {kv} kv heads of {rep} each, d {dh}, over {n} sequence "
          f"shards: max_abs_diff {err:.3e} against the unsharded attention "
          f"(p in float32 in both); the slot written in shard "
          f"{filled // (t // n)}, the other shards' slices kept")
    return err


def mesh_serve(dev) -> dict:
    """Phase 15 (a): `MESH_ARCH` at full width, `MESH_LAYERS` layers, served
    on a (data 1, model 4) mesh of ``cuda:0`` in the serving layout
    (``param_specs(serve=True)``): ``make_forward`` over 1 x
    `PREFILL_TOKENS` positions against the single-device forward on the
    same weights (`hold_chunked`), one flash launch a layer a shard (the
    local group: 4 query heads over 1 kv head) and one hot-slab launch;
    ``make_serve_step`` over a `MESH_DECODE` cache laid out by
    ``cache_specs`` (sequence-sharded: 2 kv heads do not divide 4),
    teacher-forced steps against the single-device ``decode_step`` from
    the same cache; and `seqsharded_attention_check`."""
    import torch
    from repro_torch.core.dist import CollectiveLedger
    from repro_torch.launch.shardings import shard_tree
    from repro_torch.models.transformer import (ShardedModel, decode_step,
                                                forward, init_cache)
    from repro_torch.train.steps import make_forward, make_serve_step
    cfg = grad_cut(MESH_ARCH, MESH_LAYERS)
    mesh = mesh_of(MESH_SERVE)
    model = draw_weights(cfg, dev)
    n = PREFILL_TOKENS or 32_768
    batch = {"tokens": token_source(cfg, n)(3, n).to(dev)}
    one_ms = cuda_ms(lambda: forward(model, batch), reps=2, warmup=1)
    want = forward(model, batch)[0]
    fwd = make_forward(cfg, mesh)
    sm = ShardedModel.from_model(model, mesh, serve=True)
    held = shard_bytes([sm.params])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_lm_launches()
    with CollectiveLedger() as ledger:
        got = fwd(sm, batch)[0]
    torch.cuda.synchronize()
    launches = lm_launches()
    calls = cfg.num_layers * mesh.size
    mesh_launches(launches, {**mesh_flash(cfg, mesh, 1), "hot_embed": 1,
                             "moe_gmm": 0}, "mesh prefill")
    hold = hold_chunked(f"mesh prefill [{cfg.name}, {MESH_SERVE}] against "
                        f"one device", got, want)
    del got, want
    ms = cuda_ms(lambda: fwd(sm, batch), reps=2, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    collectives = ledger.as_dict()
    print(f"mesh prefill [{cfg.name}, {cfg.num_layers} layers, data x model "
          f"= {MESH_SERVE}]: {ms:.1f} ms ({n / ms * 1e3:.0f} tokens/s; one "
          f"device {one_ms:.1f} ms), "
          f"{calls} flash launches, peak {peak:.1f} GiB; each shard holds "
          f"{[round(b / 2**30, 3) for b in held]} GiB of params; "
          f"collectives a forward, bytes a device: {collectives}")

    b, t, filled, steps = (MESH_DECODE[k] for k in ("batch", "cache",
                                                    "filled", "steps"))
    cache = init_cache(cfg, b, t, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for leaf in ("k", "v"):
        c = cache["layers"][leaf]
        c[:, :, :filled] = torch.randn(c[:, :, :filled].shape, generator=gen,
                                       device=dev).to(c.dtype)
    cache["layers"]["length"].fill_(filled)
    cache["pos"].fill_(filled)
    serve = make_serve_step(cfg, mesh, b, t)
    if serve.cspecs["layers"]["k"][2] != "model":
        raise AssertionError(f"{cfg.name}'s cache is not sequence-sharded")
    scache = shard_tree(cache, serve.cspecs, mesh)
    src = token_source(cfg, steps, quiet=True)
    toks = torch.cat([src(s, steps) for s in range(4, 4 + b)]).to(dev)
    outs, walls, dlaunch = ([], []), [], {}
    for i in range(steps):
        tok = toks[:, i:i + 1]
        a, cache = decode_step(model, cache, tok)
        torch.cuda.synchronize()
        before = lm_launches()
        t0 = time.perf_counter()
        with CollectiveLedger() as dled:
            c, scache = serve(sm, scache, tok)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for k, v in lm_launches().items():
            dlaunch[k] = dlaunch.get(k, 0) + v - before[k]
        outs[0].append(c)
        outs[1].append(a)
    # a decode step: one hot-slab lookup (the shards share the card and
    # their rows), attention over the cache in plain torch
    mesh_launches(dlaunch, {"hot_embed": steps, "flash_attn": 0},
                  "mesh decode")
    dec = hold_chunked(f"mesh decode [{cfg.name}], {steps} teacher-forced "
                       f"steps from {filled} cached positions, against one "
                       f"device", torch.cat(outs[0], 1), torch.cat(outs[1], 1))
    if int(scache["pos"].shards[0]) != filled + steps:
        raise AssertionError("the sharded cache's position did not advance")
    step_ms = 1e3 * sorted(walls)[len(walls) // 2]
    print(f"mesh decode [{cfg.name}]: median step {step_ms:.1f} ms wall "
          f"({b} rows), collectives a step, bytes a device: "
          f"{dled.as_dict()}")
    err = seqsharded_attention_check(dev, cfg, mesh)
    del model, sm, cache, scache
    torch.cuda.empty_cache()
    return {"launches": launches, "decode_launches": dlaunch,
            "prefill_ms": ms, "one_device_ms": one_ms,
            "tokens_per_s": n / ms * 1e3, "peak_gib": peak,
            "shard_gib": [x / 2**30 for x in held], "hold": hold,
            "decode": {**dec, "step_ms": step_ms},
            "collectives": collectives, "seq_attn_err": err}


def sharded_loss_and_grads(sm, batch) -> tuple[float, dict]:
    """One batch's loss and every leaf's whole float32 gradient on the CPU
    (replicas summed, `train.steps.sharded_grads`), by tree path."""
    from repro_torch.launch.shardings import ShardedTensor
    from repro_torch.train.optim import TrainConfig, _leaves
    from repro_torch.train.steps import sharded_grads
    m = sharded_grads(sm, batch, TrainConfig())
    grads = {"/".join(map(str, path)): ShardedTensor(
        [t.grad for t in st.shards], st.spec, st.mesh, st.shape).full(
        "cpu").float() for path, st in _leaves(sm.params)}
    for p in sm.parameters():
        p.grad = None
    return float(m["loss"]), grads


def mesh_train(dev) -> dict:
    """Phase 15 (b): `MESH_ARCH` at full width, `MESH_LAYERS` layers,
    remat on, trained on a (2, 2) mesh of ``cuda:0`` (FSDP over ``data``,
    TP over ``model``): `TRAIN_BATCH` x `TRAIN_SEQ` tokens in microbatches
    of `TRAIN_MICROBATCH`, at `MESH_LR` (constant). The same weights on
    one device give the reference step: the loss within 1e-2 and each
    leaf's gradient within 5e-2 relative L2 (`hold_grads`); after the
    update every shard's slice of the params within one AdamW step's reach
    of `shard_tree`'s slice of the one-device params, of the first moment
    within 5e-2 and of the second within 1e-1 relative L2 (it holds the
    gradient's square). Then a second step timed: seconds, tokens/s,
    peak GiB, the bytes each shard holds and the collectives' bytes."""
    import torch
    from repro_torch.core.dist import CollectiveLedger
    from repro_torch.launch.shardings import shard_tree
    from repro_torch.models.transformer import ShardedModel, param_tree
    from repro_torch.train import steps as TS
    from repro_torch.train.optim import TrainConfig, _leaves, init_opt_state
    cfg = grad_cut(MESH_ARCH, MESH_LAYERS)
    if not cfg.remat:
        raise AssertionError(f"{cfg.name} trains with remat")
    mesh = mesh_of(MESH_TRAIN)
    tc = TrainConfig(microbatch=TRAIN_MICROBATCH, learning_rate=MESH_LR,
                     warmup_steps=0, schedule="const")
    src = token_source(cfg, TRAIN_SEQ, quiet=True)
    batches = [{"tokens": torch.cat([src(1 + s * TRAIN_BATCH + r, TRAIN_SEQ)
                                     for r in range(TRAIN_BATCH)]).to(dev)}
               for s in range(2)]
    model = draw_weights(cfg, dev)
    step = TS.make_train_step(cfg, tc, mesh)
    sm = ShardedModel.from_model(model, mesh)
    opt = TS.init_sharded_opt_state(sm)
    one_opt = init_opt_state(param_tree(model))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m1 = TS._grads(cfg, tc, model, batches[0])
    torch.cuda.synchronize()
    one_grad_s = time.perf_counter() - t0
    want = {"/".join(map(str, p)): g.grad.float()
            for p, g in _leaves(param_tree(model))}
    torch.cuda.synchronize()
    reset_lm_launches()
    bwd0 = bwd_snapshot()
    t0 = time.perf_counter()
    with CollectiveLedger() as ledger:
        m2 = TS.sharded_grads(sm, batches[0], tc)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    launches = {**lm_launches(), **bwd_delta(bwd0)}
    micro = TRAIN_BATCH // TRAIN_MICROBATCH
    layers = cfg.num_layers * mesh.size
    # each microbatch: the forward and its replay, then the backward; one
    # embedding lookup a data shard
    mesh_launches(launches, {
        **mesh_flash(cfg, mesh, 2 * micro),
        "flash_bwd_dq": layers * micro, "flash_bwd_dkdv": layers * micro,
        "hot_embed": micro * mesh.shape["data"], "moe_gmm": 0},
        "mesh training")
    got = {}
    for path, st in _leaves(sm.params):
        got["/".join(map(str, path))] = type(st)(
            [t.grad for t in st.shards], st.spec, st.mesh, st.shape).full(
            ).float()
    # the key bias's exact gradient is zero (it adds q·bk to every logit
    # of a row, which the softmax removes): each run's is rounding noise
    # of its own, printed but not held (tests/test_torch_train.py holds
    # only the bound of an AdamW step for it, as the params check below)
    noise = {n: float((got.pop(n) - want[n]).norm()
                      / want.pop(n).norm().clamp(min=1e-30))
             for n in [n for n in want if n.endswith("attn/bk")]}
    worst, err, _ = hold_grads(f"mesh train [{cfg.name}] against one device",
                               got, want, float(m2["loss"]),
                               float(m1["loss"]))
    del got, want
    TS.apply(model, one_opt, m1, tc)
    _, opt, m2 = TS.apply_sharded(sm, opt, m2, tc)
    reach = 2 * MESH_LR + 1e-6
    whole = shard_tree({"params": param_tree(model), "mu": one_opt["mu"],
                        "nu": one_opt["nu"]},
                       {"params": step.pspecs, "mu": step.pspecs,
                        "nu": step.pspecs}, mesh)
    worst_m = {"mu": 0.0, "nu": 0.0}
    for kind, tree in (("params", sm.params), ("mu", opt["mu"]),
                       ("nu", opt["nu"])):
        for (path, a), (_, b) in zip(_leaves(tree), _leaves(whole[kind])):
            for x, y in zip(a.shards, b.shards):
                if kind == "params":
                    d = (x - y).abs()
                    lim = reach * (1 + 0.1 * float(y.abs().max()))
                    if float(d.max()) > lim:
                        raise AssertionError(f"mesh train: {path}'s slice "
                                             f"parts by {float(d.max())}")
                    continue
                if path[-2:] == ("attn", "bk"):    # noise, as above
                    continue
                rel = float((x - y).norm() / y.norm().clamp(min=1e-30))
                worst_m[kind] = max(worst_m[kind], rel)
    if worst_m["mu"] > 5e-2 or worst_m["nu"] > 1e-1:
        raise AssertionError(f"mesh train: the moments' slices part {worst_m}")
    del whole, model, one_opt
    torch.cuda.empty_cache()
    held = shard_bytes([sm.params, opt["mu"], opt["nu"]])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sm, opt, m = step(sm, opt, batches[1])
    loss = float(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = {"loss": [float(m1["loss"]), loss], "grad_s": grad_s,
            "one_device_grad_s": one_grad_s,
            "seconds": dt, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / dt,
            "peak_gib": peak, "shard_gib": [x / 2**30 for x in held],
            "worst_grad": [worst, err], "moments_rel_l2": worst_m,
            "bk_rel_l2": max(noise.values(), default=0.0),
            "collectives": ledger.as_dict()}
    print(f"mesh train [{cfg.name}, {cfg.num_layers} layers, data x model = "
          f"{MESH_TRAIN}]: a step's gradients {grad_s:.2f} s (one device "
          f"{one_grad_s:.2f} s), against one device worst {worst} at "
          f"{err:.3e}; params, mu and nu slices held (mu {worst_m['mu']:.2e}, "
          f"nu {worst_m['nu']:.2e}); step 2 loss {loss:.4f} in {dt:.2f} s "
          f"({rows['tokens_per_s']:.0f} tokens/s), peak {peak:.1f} GiB; "
          f"each shard holds {[round(x / 2**30, 3) for x in held]} GiB of "
          f"params and moments; collectives a step's forwards, bytes a "
          f"device: {rows['collectives']}")
    del sm, opt
    torch.cuda.empty_cache()
    return {"launches": launches, **rows}


def mesh_moe_grad_batch(cfg) -> dict:
    """(c)'s card-against-CPU batch: `MESH_MOE_GRAD` rows of the token
    source."""
    import torch
    rows, seq = MESH_MOE_GRAD
    src = token_source(cfg, seq, quiet=True)
    return {"tokens": torch.cat([src(1 + r, seq) for r in range(rows)])}


def host_mesh_moe(threads: int, path: str) -> str:
    """Phase 15 (c)'s CPU half, in a pool worker: `MOE_ARCH` at full width
    cut to `MESH_MOE_GRAD_LAYERS` layer(s), `draw_weights` to the CPU, on
    a (2, 2) mesh of CPU shards, one batch's loss and gradients through
    the capacity dispatch (plain versions), its expert choices
    (`RouteTape`) and dropped rows (`DropTape`). Saves them to ``path``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import DropTape, RouteTape
    from repro_torch.models.transformer import ShardedModel
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    cfg = grad_cut(MOE_ARCH, MESH_MOE_GRAD_LAYERS)
    host = draw_weights(cfg, "cpu")
    digest = weight_digest(host)
    sm = ShardedModel.from_model(host, make_mesh(MESH_TRAIN, MESH_AXES,
                                                 "cpu"))
    del host
    batch = mesh_moe_grad_batch(cfg)
    t1 = time.perf_counter()
    with RouteTape() as route, DropTape() as drops:
        loss, grads = sharded_loss_and_grads(sm, batch)
    return spool({"batch": batch, "loss": loss, "grads": grads,
                  "digest": digest, "experts": route.experts,
                  "drops": drops.totals(), "threads": threads,
                  "init_s": t1 - t0, "grads_s": time.perf_counter() - t1},
                 path)


def mesh_moe(dev, host) -> dict:
    """Phase 15 (c): `MOE_ARCH` at full width, `MESH_MOE_LAYERS` layers, on
    a (2, 2) mesh of ``cuda:0`` through the TP-within-expert capacity
    dispatch: a prefill forward of 1 x `MESH_MOE_PREFILL` tokens (the
    batch of one row replicated over ``data``, its flattened tokens cut in
    halves over it, as the reference's ``shard_map`` cuts them), then one
    training step of `MESH_MOE_TRAIN` rows in microbatches of
    `TRAIN_MICROBATCH`; each with its ``moe_gmm`` launches (every group
    ``cap`` rows; ``tgmm`` and dX in the backward) and its rows kept and
    dropped. Then the card against the CPU (``host``, a future of
    `host_mesh_moe`) at `MESH_MOE_GRAD_LAYERS` layer(s) on the CPU's
    expert choices (`RouteTape`): the loss and gradients at
    `hold_grads`'s standard, the rows kept and dropped equal."""
    import torch
    from repro_torch.core.dist import CollectiveLedger
    from repro_torch.models.moe import DropTape, RouteTape, capacity
    from repro_torch.models.transformer import ShardedModel, forward
    from repro_torch.train import steps as TS
    from repro_torch.train.optim import TrainConfig
    cfg = grad_cut(MOE_ARCH, MESH_MOE_LAYERS)
    mesh = mesh_of(MESH_TRAIN)
    sm = ShardedModel.from_model(draw_weights(cfg, dev), mesh)
    torch.cuda.empty_cache()
    n = MESH_MOE_PREFILL
    batch = {"tokens": token_source(cfg, n, quiet=True)(3, n).to(dev)}
    reset_lm_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with DropTape() as drops, CollectiveLedger() as ledger:
        logits = forward(sm, batch)[0]
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    pre = lm_launches()
    shards = mesh.size
    mesh_launches(pre, {**mesh_flash(cfg, mesh, 1), "hot_embed": 1,
                        "moe_gmm": 3 * cfg.num_layers * shards,
                        "moe_gmm_tgmm": 0}, "mesh MoE prefill")
    if logits.shape != (1, n, cfg.vocab_size) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError("mesh MoE prefill: logits of another shape or "
                             "not finite")
    pre_drops = {**drops.totals(), "by_layer": drops_by_layer(drops, shards)}
    cap = capacity(n // mesh.shape["data"], cfg)
    if pre_drops["capacities"] != [cap]:
        raise AssertionError(f"mesh MoE prefill: capacities "
                             f"{pre_drops['capacities']}, expected {cap}")
    print(f"mesh MoE prefill [{cfg.name}, {cfg.num_layers} layers, "
          f"{MESH_TRAIN}]: {n} tokens in {fwd_s:.2f} s, capacity {cap} rows "
          f"an expert, {pre_drops['kept']} rows kept and "
          f"{pre_drops['dropped']} dropped over {pre_drops['calls']} "
          f"dispatches ((kept, dropped) a layer {pre_drops['by_layer']}); "
          f"launches {pre}; collectives, bytes a device: "
          f"{ledger.as_dict()}")
    del logits
    tc = TrainConfig(microbatch=TRAIN_MICROBATCH, learning_rate=MESH_LR,
                     warmup_steps=0, schedule="const")
    rows, seq = MESH_MOE_TRAIN
    src = token_source(cfg, seq, quiet=True)
    tbatch = {"tokens": torch.cat([src(4 + r, seq)
                                   for r in range(rows)]).to(dev)}
    step = TS.make_train_step(cfg, tc, mesh)
    opt = TS.init_sharded_opt_state(sm)
    reset_lm_launches()
    bwd0 = bwd_snapshot()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with DropTape() as tdrops:
        sm, opt, m = step(sm, opt, tbatch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    train = {**lm_launches(), **bwd_delta(bwd0)}
    micro = rows // TRAIN_MICROBATCH
    prods = 3 * cfg.num_layers * shards * micro
    # the forward and its replay, and dX, through moe_gmm; dW through tgmm
    mesh_launches(train, {**mesh_flash(cfg, mesh, 2 * micro),
                          "moe_gmm": 3 * prods, "moe_gmm_tgmm": prods,
                          "flash_bwd_dq": cfg.num_layers * shards * micro,
                          "hot_embed": micro * mesh.shape["data"]},
                  "mesh MoE training")
    held = shard_bytes([sm.params, opt["mu"], opt["nu"]])
    td = {**tdrops.totals(), "by_layer": drops_by_layer(tdrops, shards)}
    print(f"mesh MoE train [{cfg.name}]: one step of {rows}x{seq} tokens, "
          f"loss {loss:.4f}, {dt:.2f} s ({rows * seq / dt:.0f} tokens/s), "
          f"peak {peak:.1f} GiB; each shard holds "
          f"{[round(x / 2**30, 3) for x in held]} GiB; capacity "
          f"{td['capacities']}, {td['kept']} rows kept and {td['dropped']} "
          f"dropped (forward and replay; (kept, dropped) a layer a call "
          f"{td['by_layer']}); launches {train}")
    if not (loss == loss and loss < 1e4):
        raise AssertionError(f"mesh MoE train: loss {loss}")
    del sm, opt
    torch.cuda.empty_cache()

    cut = grad_cut(MOE_ARCH, MESH_MOE_GRAD_LAYERS)
    label = f"mesh MoE card vs CPU [{cut.name}, depth {cut.num_layers}]"
    card = draw_weights(cut, dev)
    cpu = host_result(host, label, card)
    smc = ShardedModel.from_model(card, mesh)
    del card
    batch = mesh_moe_grad_batch(cut)
    same_batch(label, cpu["batch"], batch)
    with RouteTape(cpu["experts"]), DropTape() as cdrops:
        got_loss, got = sharded_loss_and_grads(
            smc, {"tokens": batch["tokens"].to(dev)})
    worst, err, rel = hold_grads(label, got, cpu["grads"], got_loss,
                                 cpu["loss"])
    if cdrops.totals() != cpu["drops"]:
        raise AssertionError(f"{label}: rows kept and dropped "
                             f"{cdrops.totals()} on the card, "
                             f"{cpu['drops']} on the CPU")
    print(f"{label}: {MESH_MOE_GRAD} tokens, remat on, the CPU's routing "
          f"replayed: loss {got_loss:.6f} against {cpu['loss']:.6f}, the "
          f"worst leaf {worst} at {err:.3e} relative L2 of {len(rel)}; rows "
          f"kept and dropped equal on both: {cpu['drops']}")
    del smc, got, cpu
    torch.cuda.empty_cache()
    launches = {k: pre.get(k, 0) + train.get(k, 0)
                for k in set(pre) | set(train)}
    return {"launches": launches, "prefill_s": fwd_s,
            "prefill_drops": pre_drops, "train_drops": td,
            "step_s": dt, "tokens_per_s": rows * seq / dt, "peak_gib": peak,
            "shard_gib": [x / 2**30 for x in held],
            "card_vs_cpu": {"worst": worst, "rel_l2": err,
                            "drops": cdrops.totals()}}


def mesh_phase(dev, pool: HostPool) -> dict:
    """Phase 15: the LM on a (data, model) mesh of 4 shards of one card:
    (a) `mesh_serve`, (b) `mesh_train`, (c) `mesh_moe`, whose CPU half a
    pool worker makes beside (a) and (b). Each part prints its wall."""
    import torch
    host = pool._submit(host_mesh_moe, "mesh-moe", pool_threads())
    serve = timed("15a [mesh serve]", mesh_serve, dev)
    train = timed("15b [mesh train]", mesh_train, dev)
    moe = timed("15c [mesh MoE]", mesh_moe, dev, host)
    torch.cuda.empty_cache()
    parts = (serve["launches"], serve["decode_launches"], train["launches"],
             moe["launches"])
    launches = {k: sum(x.get(k, 0) for x in parts)
                for k in set().union(*parts)}
    return {"serve": serve, "train": train, "moe": moe,
            "launches": launches}


def timed(label: str, fn, *args):
    """``fn(*args)``, its wall seconds printed under ``label``."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s wall")
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from the root of "
              "a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    sys.path.insert(0, str(ROOT / "src"))
    configs = lm_configs()
    cores = os.cpu_count() or 1
    torch.set_num_threads(max(1, cores - cores // 2))
    print(f"host: {cores} cores; a pool of {POOL_WORKERS} spawned workers; "
          f"a phase 9 job takes {pool_threads()} torch thread(s), each of "
          f"phase 14's {pool_threads(GradJobs.AHEAD)}; the main process "
          f"keeps {torch.get_num_threads()}")
    # the graph oracles and the k-NN corpora's host NSW builds beside
    # phases 1-5; later the CPU's halves of the card-against-CPU checks
    # (`HostPool`), whose results the workers save in a temporary
    # directory of the run's (`spool`)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_host_")
    try:
        with ProcessPoolExecutor(
                POOL_WORKERS,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            oracles = [pool.submit(graph_oracles, NUM_VERTICES, part)
                       for part in ORACLE_PARTS]
            corpora = {kind: pool.submit(search_corpus, kind)
                       for kind in ("clustered", "integer", "reference")}
            host = HostPool(pool, tmp)
            try:
                return run(torch, corpora, oracles, configs, host)
            finally:
                for f in (*oracles, *corpora.values(), *host.jobs):
                    f.cancel()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(torch, corpora: dict, oracles: list, configs: dict,
        host: HostPool) -> int:
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, kernel in (("csr_spmv", "csr_spmv_merge"),
                         ("csr_spmv", "csr_spmv_carries"),
                         ("flash_attn", "flash_fwd_bf16_wgmma"),
                         ("flash_attn", "flash_fwd_bf16_mma"),
                         ("flash_attn", "flash_bwd_dq_bf16"),
                         ("flash_attn", "flash_bwd_dkdv_bf16"),
                         ("flash_attn", "flash_bwd_dq_wgmma"),
                         ("flash_attn", "flash_bwd_dkdv_wgmma"),
                         ("moe_gmm", "gmm_bf16_wgmma"),
                         ("moe_gmm", "gmm_bf16_splitk"),
                         ("moe_gmm", "gmm_bf16_tgmm")):
        for line in _build.ptxas_report(name, kernel):
            print(f"ptxas: {line}")
    smem = _build.load("csr_spmv").csr_spmv_smem_bytes()
    print(f"csr_spmv_merge: {smem} bytes of dynamic shared memory "
          f"a block")
    tgmm_ptxas = ptxas_gate("moe_gmm", "gmm_bf16_tgmm", TGMM_PTXAS_KEY,
                            {"f", "13__nv_bfloat16"})
    flash_ptxas = ptxas_gate("flash_attn", "flash_fwd_bf16_wgmma",
                             FLASH_FWD_PTXAS_KEY, FLASH_FWD_INSTANCES)
    bwd_ptxas = {k: ptxas_gate("flash_attn", k, r"ILi(\d+)E",
                               FLASH_BWD_INSTANCES)
                 for k in FLASH_BWD_KERNELS}

    err = timed("3 spmv checks", kernel_cases, dev)
    served = timed("4 graph serve", serve, dev, NUM_VERTICES, oracles)
    timing, served_err = timed("5 spmv timing", time_spmv, served["entry"])
    served["session"].close()
    spmv_launches = served["launches"]["csr_spmv"]
    single = {k: served[k]
              for k in ("graph", "sources", "answers", "walls", "warm")}
    del served
    torch.cuda.empty_cache()
    timed("4s sharded serve", sharded_serve, dev, single, corpora, card)
    del single
    torch.cuda.empty_cache()
    timed("k-NN", knn_phase, dev, corpora, card)
    torch.cuda.empty_cache()

    from repro_torch.configs import get_config
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must not run in TF32: the "
                             "router and the plain versions need float32")
    flash_err, hot_err = timed("6 LM kernel checks", lm_kernel_cases, dev)

    def lm(label, arch):
        cfg, full = configs[arch]
        return timed(f"{label} {arch}", run_lm, dev, cfg, host, full)
    mini = lm("7-11", ARCH)
    qwen = lm("7-11", GQA_ARCH)
    pali = lm("7-11", PREFIX_ARCH)
    hubert = lm("7, 9, 11", ENCODER_ARCH)
    rwkv = lm("7-11", RWKV_ARCH)
    zamba = lm("7-11", HYBRID_ARCH)
    glm = lm("7-11", GLM_ARCH)
    code = lm("7-11", CODE_ARCH)

    gmm_err = timed("12 moe_gmm checks", gmm_kernel_cases, dev)
    moe = lm("13", MOE_ARCH)
    swa = lm("13", SWA_ARCH)
    timed(f"13 {SWA_ARCH} smoke ring", ring_decode_check, dev)
    train = timed("14 training", train_phase, dev, host)
    mesh = timed("15 mesh", mesh_phase, dev, host)
    runs = (mini, qwen, pali, hubert, rwkv, zamba, glm, code, moe, swa)

    def launches(name):
        return (sum(r[w].get(name, 0) for r in runs for w in ("pre", "serve"))
                + train["launches"].get(name, 0)
                + mesh["launches"].get(name, 0))

    def bwd_groups(counts):     # training's backward launches by kv group
        return {k[len("flash_bwd_group"):]: v for k, v in sorted(
            counts.items()) if k.startswith("flash_bwd_group")}

    kernels = [{
        "name": "csr_spmv",
        "route": "cuda",
        "source": "src/repro_torch/csrc/csr_spmv.cu",
        "replaces": "src/repro/kernels/csr_spmv/csr_spmv.py:88",
        "launches": spmv_launches,
        "max_abs_err": max(err, served_err),
        **timing,
    }, {
        "name": "flash_attn",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/flash_attn.py:66",
        "launches": launches("flash_attn"),
        "launches_by_variant": {
            "wgmma": launches("flash_attn_wgmma"),
            "mma_sync": launches("flash_attn_mma_sync")},
        "launches_by_mask": {
            "prefix": launches("flash_attn_prefix"),
            "non_causal": launches("flash_attn_non_causal")},
        "launches_grouped_query": launches("flash_attn_gqa"),
        "launches_windowed": launches("flash_attn_windowed"),
        "launches_mesh": mesh["launches"].get("flash_attn", 0),
        "max_abs_err": max([flash_err] + [r["flash_err"] for r in runs]),
        "ptxas": flash_ptxas,
        **mini["timing"]["flash_attn"],
        GQA_ARCH: qwen["timing"]["flash_attn"],
        PREFIX_ARCH: pali["timing"]["flash_attn"],
        ENCODER_ARCH: hubert["timing"]["flash_attn"],
        HYBRID_ARCH: zamba["timing"]["flash_attn"],
        GLM_ARCH: glm["timing"]["flash_attn"],
        CODE_ARCH: code["timing"]["flash_attn"],
        MOE_ARCH: moe["timing"]["flash_attn"],
        SWA_ARCH: swa["timing"]["flash_attn"],
    }, {
        "name": "flash_attn_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "none: no TPU kernel; the reference differentiates "
                    "src/repro/models/layers.py:117 (_sdpa_chunked) in XLA",
        "launches": launches("flash_bwd_dq") + launches("flash_bwd_dkdv"),
        "launches_by_kernel": {"dq": launches("flash_bwd_dq"),
                               "dkdv": launches("flash_bwd_dkdv")},
        "launches_by_variant": {"wgmma": launches("flash_bwd_wgmma"),
                                "mma_sync": launches("flash_bwd_mma_sync")},
        "launches_by_group": bwd_groups(train["launches"]),
        "launches_windowed": launches("flash_bwd_windowed"),
        "launches_mesh": mesh["launches"].get("flash_bwd_dq", 0)
        + mesh["launches"].get("flash_bwd_dkdv", 0),
        "max_abs_err": train["err"],
        **{k: train["timing"][0][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound7_ms", "dq_ms", "dkdv_ms", "dq_tflops", "dkdv_tflops")},
        "library": train["timing"][0]["library"],
        "shape": train["timing"][0]["shape"],
        ARCH: train["timing"][1],
        PREFIX_ARCH: {**train["timing"][2],
                      "launches_by_variant": {
                          k[len("flash_bwd_"):]: train["prefix"][
                              "launches"][k]
                          for k in ("flash_bwd_wgmma", "flash_bwd_mma_sync")},
                      "ptxas": {k: v["256"] for k, v in bwd_ptxas.items()}},
        HYBRID_ARCH: {**train["timing"][3],
                      "launches_by_variant": {
                          k[len("flash_bwd_"):]: train["recurrent"][
                              HYBRID_ARCH]["launches"][k]
                          for k in ("flash_bwd_wgmma", "flash_bwd_mma_sync")}},
        **{arch: {**train["timing"][i],
                  "launches_by_group": bwd_groups(train["wide"][arch][
                      "launches"]),
                  "launches_windowed": train["wide"][arch]["launches"][
                      "flash_bwd_windowed"]}
           for arch, i in ((GLM_ARCH, 4), (CODE_ARCH, 5), (SWA_ARCH, 6))},
        f"{SWA_ARCH} causal": train["timing"][7],
        "ptxas": bwd_ptxas,
    }, {
        "name": "hot_embed",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hot_embed.cu",
        "replaces": "src/repro/kernels/hot_embed/hot_embed.py:37",
        "launches": launches("hot_embed"),
        "launches_mesh": mesh["launches"].get("hot_embed", 0),
        "max_abs_err": max([hot_err] + [r["hot_err"] for r in runs]),
        **mini["timing"]["hot_embed"],
        GQA_ARCH: qwen["timing"]["hot_embed"],
        PREFIX_ARCH: pali["timing"]["hot_embed"],
        RWKV_ARCH: rwkv["timing"]["hot_embed"],
        HYBRID_ARCH: zamba["timing"]["hot_embed"],
        GLM_ARCH: glm["timing"]["hot_embed"],
        CODE_ARCH: code["timing"]["hot_embed"],
        MOE_ARCH: moe["timing"]["hot_embed"],
        SWA_ARCH: swa["timing"]["hot_embed"],
    }, {
        "name": "moe_gmm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:50",
        "launches": launches("moe_gmm"),
        "launches_by_variant": {"wgmma": launches("moe_gmm_wgmma"),
                                "splitk": launches("moe_gmm_splitk")},
        "launches_mesh": mesh["launches"].get("moe_gmm", 0),
        "max_abs_err": max(gmm_err, moe["gmm_err"], swa["gmm_err"]),
        **moe["gmm_timing"],
        SWA_ARCH: swa["gmm_timing"],
    }, {
        "name": "moe_gmm_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/moe_gmm.cu",
        "replaces": "none: no TPU kernel; the reference differentiates "
                    "lax.ragged_dot (src/repro/models/moe.py:51-54) in XLA",
        "kernel": "gmm_bf16_tgmm",
        "launches": launches("moe_gmm_tgmm"),
        "launches_mesh": mesh["launches"].get("moe_gmm_tgmm", 0),
        "max_abs_err": max(train["moe"]["err"],
                           train["wide"][SWA_ARCH]["err"]),
        **{k: train["moe"]["timing"]["gate"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "dx")},
        "library": "torch._grouped_mm(xT, dY, offs=)",
        "down": train["moe"]["timing"]["down"],
        SWA_ARCH: {**train["wide"][SWA_ARCH]["timing"],
                   "launches": train["wide"][SWA_ARCH]["launches"][
                       "moe_gmm_tgmm"]},
        "ptxas": tgmm_ptxas,
    }]
    for r in (rwkv, zamba):
        print(f"scan: {json.dumps(r['scan'])}")
    print(f"train: {json.dumps(train['steps'])}")
    print(f"train profile: {json.dumps(train['profile'])}")
    print(f"train [{PREFIX_ARCH}]: {json.dumps(train['prefix']['steps'])}")
    print(f"train profile [{PREFIX_ARCH}]: "
          f"{json.dumps(train['prefix']['profile'])}")
    print(f"train [{MOE_ARCH}]: {json.dumps(train['moe']['steps'])}")
    print(f"train profile [{MOE_ARCH}]: "
          f"{json.dumps(train['moe']['profile'])}")
    for arch, r in train["wide"].items():
        print(f"train [{arch}, depth {TRAIN_DEPTH[arch]}]: "
              f"{json.dumps(r['steps'])}")
        print(f"train profile [{arch}]: {json.dumps(r['profile'])}")
    for (arch, r), lm in zip(train["recurrent"].items(), (rwkv, zamba)):
        loop = lm["scan"]["train_fwd_bwd"]
        # each layer's loop a microbatch: forward, replay and backward
        loops = (get_config(arch).num_layers * r["profile"]["microbatches"]
                 * (2 * loop["loop_fwd_ops"] + loop["loop_bwd_ops"]))
        ops = r["profile"]["device_ops"]
        print(f"train [{arch}]: the state loops' launches in the profiled "
              f"step ({r['profile']['microbatches']} microbatch(es)) "
              f"{loops} of its {ops} device ops ({100 * loops / ops:.1f}%)")
        print(f"train [{arch}]: {json.dumps(r['steps'])}")
        print(f"train profile [{arch}]: {json.dumps(r['profile'])}")
    print(f"mesh: {json.dumps(mesh, default=str)}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
