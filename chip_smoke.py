#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Builds the port's CUDA kernels (``src/repro_torch/kernels/csrc/
xbar_vmm.cu``: the forward and transpose reads; ``xbar_update.cu``: the
rank-k write, outer and pulse-train; ``xbar_fakequant.cu``: the fakequant
read, FP32 and tensor-core instances; ``flash_attention.cu``) with one
nvcc per source, all started together, checks in ``cuobjdump -sass`` that
the tensor-core read kernels, both tensor-core write instances, the
tensor-core fakequant read and every flash-attention instance issue HMMA
(tensor-core) instructions, then runs these phases and exits non-zero if
any gate fails:

1. forward read vs plain version on the card, at the shapes of lm100m's
   four crossbar containers (64x64 tiles) at decode (B=4), prefill-chunk
   (B=16) and training (B=2048) batch sizes, plus a ragged case, 128x128,
   256x256 and 1024x1024 tiles and a large-batch case on the FP32
   instance (B <= 16) and the tensor-core one (B > 16; also 48x48 tiles),
   and a 12-bit DAC case (the FP32 instance at B > 16).  Two parity
   classes:
     * fixed ADC range with a power-of-two lsb on conductances on the
       device's 1/256 pulse grid: every tile charge is an exact float32
       sum, so the kernel must be bit-equal to the plain version;
     * dynamic ADC range on arbitrary conductances (the serving and
       training class): the tile charges are float32 sums taken in
       another order, so an ADC code may flip by one level where a charge
       sits within rounding of a code boundary.  Every element must lie
       within one lsb per reduction tile (times the output scale) of the
       plain version, and fewer than 1% of the elements may differ by
       more than 1e-5 relative.  The range is the rms over a tile's
       non-zero charges, and a charge within float32 rounding of 0 is 0
       in one summation order and not in another, which moves the whole
       tile's lsb by about 0.2%: where the share reaches 1%, a tile with
       such a tie counts in it by its errors against the plain read
       recounted at the tie (``tie_recount``), where that leaves fewer
       off.
   Full-width decode and training cases are timed (kernel device time
   from torch.profiler, and back-to-back CUDA-event time beside it, which
   stands in where the profiler records no kernel; conductances cycled
   through copies so each read misses L2) against the FP32 bound (bytes
   at decode, operations at B=2048), beside the tensor-core instance's
   own bound.
2. lm100m at full width served from programmed TaOx crossbars (random
   weights from torch.Generator seed 0) by the continuous scheduler: 4
   slots, prefill chunk 16, 4 prompts of 8-16 tokens, 32 greedy tokens.
   The read count must be 48 (4 containers x 12 layers) per model call;
   each read launches its read kernel and either the kernel that sums the
   tile partials in K order (FP32 instance) or the pre-pass (DAC codes,
   split conductance pair) and
   the range pass (tensor-core instance).  One digital-backend request
   follows.
3. the same weights and tokens on the card and on the CPU (the plain
   version): prefill logits and 4 decode steps fed the card's greedy
   tokens.  Gates: every read of the card's run against the plain version
   on the CPU fed the card's own read operands, with phase 1's bound; the
   card's logits against the CPU's with the card's read results replayed
   into the CPU run, within 1e-3; and, as a gross check only, the
   free-running CPU within twice the analog read's own error (analog vs
   float32 digital logits): there, 8-bit ADC codes that flip at a
   rounding boundary cascade through the layers.
4. a torch.profiler trace of 4 decode steps, reported only.
   Then a prefill and one decode step at the config's default 1024x1024
   tiles, every read against the plain version (phase 1's bound).
5. transpose read vs plain version on the card: the four containers at
   training (B = T = 2048, timed as phase 1) and B = 16, a ragged case,
   128x128 and 1024x1024 tiles, and on the tensor-core instance 48x48
   tiles and 128/256/1024 tiles at B = 64; the same two classes, the
   dynamic one within one lsb per N tile.
6. rank-k write vs plain version on the card at each container's
   (12, K, N) with T = 2048, on the tensor-core instance (operands that
   are integer codes times per-layer scales, with the scales): its
   pre-pass bit-equal to its plain twin; (a) ideal device, no noise,
   power-of-two scales, where every product and sum is exact: bit-equal;
   (b) TaOx with counter-PRNG noise and (c) TaOx with a host noise field:
   within 4 float32 ulp plus 1e-5 of each cell's move (a wrong hash moves
   a cell by a write-noise sigma) of the plain twin of its own arithmetic
   (exact sums) everywhere, and of the plain version everywhere but the
   sum-rounding ties (``tc_write_agrees``).  The FP32 instance runs (b),
   two ragged cases (48x63 and 64x15 tiles) and 1024x1024 tiles, held to
   the same bound; the tensor-core instance runs them too.  (b) is timed
   on both instances against the function's floor (bytes) and the FP32
   bound, beside the pre-pass and torch.bmm of the accumulate alone (not
   the same function).
7. lm100m at full width trained in device mode (TaOx, 64x64 tiles, 8-bit
   DAC/ADC, lr 0.1): ``init_state`` from torch.Generator seed 0 and 4
   steps of ``make_analog_sgd_step`` on 8 x 256-token batches of the
   synthetic Markov stream.  Gates: 48 forward reads, 48 transpose reads
   (each on the tensor-core instance, with its pre-pass and range
   launches; no tile-order sum) and 4 writes per step (each on the
   tensor-core instance with its pre-pass; none on the FP32 instance);
   every launch of step 1 against its plain version on the card on its
   own operands (phases 1, 5 and 6's bounds; each write's operands are
   codes times the scales it came with); the digital leaves after step 1
   against a CPU run of the step that replays the card's read and write
   results, within 1e-3 of each leaf's move plus 1e-6; finite losses and
   conductances inside the window.  Only step 1 records its launches: the
   step time, tokens/s and peak memory come from steps 2-4, which run the
   kernels bare.

8. fakequant read vs plain version on the card, on both instances (the
   FP32 one, decode's; the tensor-core one, prefill's): lm100m's four
   projections at T = 4 (decode), 16 and 2048 (prefill) with 1024-row
   tiles (the config default) and 64-row tiles, and at the instance
   threshold (``FQ_TC_MIN_TOKENS``, 144) with 1024-row tiles, two ragged
   cases (one with N = 70, 48-row tiles), and gemma-2b's w_upgate widths
   (K = 2048, N = 32768) at T = 4 and 2048.
   Two classes:
     * exact: integer drives with max|x| = 127 (DAC scale 1) and sparse
       {-1, 0, 1} weights, so every partial product and per-tile sum of
       squares is an exact float32 integer: bit-equal;
     * float32 normal operands: every element within one ADC lsb per row
       tile (the token's own) of the plain version plus 1e-5 of the
       larger of the two values, and under 1% of the elements more than
       1e-5 relative off.
   The tensor-core instance is also held to its plain twin
   (``_fakequant_tc_plain``) in the same classes, and every read's DAC
   scale, computed by its pre-pass, must equal ``fakequant_scale``.  At
   T = 4, 144 and 2048 (1024-row tiles) both instances are timed, kernel by
   kernel, against the byte bound, the FP32 bound and the tensor-core
   floor, beside the plain version and torch.matmul of the product alone
   (not the same function).
9. lm100m at full width in fakequant mode (analog=True, the default 1024
   rows, 8-bit DAC/ADC, random weights from torch.Generator seed 0)
   served from its digital tree with phase 2's settings.  Gates: 48
   fakequant reads per model call, each three counted launches (the FP32
   instance's scale and product kernels, the epilogue; none of the
   tensor-core instance) and no call of a plain version; tokens/s and one
   profiled decode step's device time, the reads' share of it, are
   reported.
10. (a) the fakequant model on the card and on the CPU, as phase 3: every
   read against the plain version on the CPU fed the card's own operands
   (phase 8's bound); logits with the card's reads replayed into the CPU
   run within 1e-3; the free-running CPU a gross check only.  (b) one
   full-width fakequant forward of 1 x 2048 tokens through
   ``model.forward``: 48 reads, all on the tensor-core instance, each
   against the plain version on its own operands (phase 8's bound); the
   logits within 1e-3 of a CPU forward with the card's reads replayed.
11. flash attention at the registry's attention shapes (lm100m 12/12
   heads of 64, starcoder2-3b 24/2 of 128, gemma-2b 8/1 of 256 at
   S = 1024, causal; a full Sq 512 x Skv 2048 case), each in float32
   (within 1e-4 of the plain version) and bfloat16 (3e-2), every case
   through ``flash_attention`` with the count set to 0 first; timed by
   the profiler and by CUDA events against the operations bound (FP32
   rate for float32, bf16 tensor-core rate for bfloat16) beside
   scaled_dot_product_attention.
12. pulse-train write vs plain version on the card at each container's
   (12, K, N) with T = 2048 and 64x64 tiles, on the tensor-core instance:
   (a) ideal device, no noise, power-of-two scales: bit-equal; (b) TaOx
   with counter-PRNG noise and (c) with a host field: the float class —
   every cell within 4 float32 ulp plus 1e-5 of its move, or, where a
   rail's count sits at a tie (mag / pulse_dg within 1e-4 relative of a
   half-integer) and the accumulators' float32 order flips it, within one
   event plus the sigma change, under 1e-3 of the cells — and within 4
   ulp plus 1e-5 of the move of its own arithmetic's plain twin; the FP32
   instance on (b), a ragged case (asymmetric TaOx, skewed float drives:
   FP32 only) and 1024x1024 tiles (both).  (b) timed by CUDA events on
   both instances, as phase 6, against the floor (4 T K N flops per
   layer) and the FP32 bound, beside torch.bmm of the two accumulates
   alone (not the same function).
13. (a) lm100m at full width trained with periodic carry (period 2, base
   4) and pulse-train writes, phase 7's settings, 4 steps.  Gates: 48
   forward and 48 transpose reads and 4 pulse-train writes per step, each
   on the tensor-core instance with its pre-pass, no FP32-instance or
   outer write and no plain-version call; every write of step 1 against
   its plain versions on its own operands (phase 12's float class); step
   1 leaves every primary array untouched and step 2's sweep moves it;
   the card's sweep against the CPU's on the card's own pre-sweep
   containers (bit-equal or one ADC code apart under 1e-3 of the cells),
   effective conductances conserved within 1e-6; finite losses,
   conductances in the window.  (b) the reference's nonideality point,
   write noise x64, carry period 4: numeric (``train_loop``, sgd 0.1,
   clip 1), no_carry, carry and carry_pulse_train, 30 steps each from
   one init on the same batches; mean loss of the last 5 steps,
   gap_vs_numeric and gap_closed_by_carry reported, finite losses gated.

14. the paper's MLP (784-300-10, batch 10, 1024x1024 tiles, 8-bit
   DAC/ADC, dynamic range) through ``train.mlp_analog``: (a) 20 steps of
   numeric, analog on ideal, taox-nonoise and taox, and pc on taox, each
   step replayed on the CPU from the card's pre-step parameters with the
   card's noise fields and read results.  Gates: per step 2 forward and
   1 transpose read (analog) or 6 and 3 (pc), all on the FP32 instance
   with no tile-order sum; every read against the plain version on its
   own operands (phase 1's bound) and its DAC scale the float32 division
   bit for bit; each layer's update within 10% (2-norm) of the replay's;
   one evaluation of the 2000 test digits, 2 (analog) or 6 (pc) reads on
   the tensor-core instance, checked alike, its accuracy equal to the
   replay's.  The B = 10 reads are timed against their byte bound.  (b)
   the six runs of ``launch.accuracy`` (Figs. 14 and 15) on its
   ``--fast`` protocol (1 epoch of 4000 digits; the ``MLPRun`` defaults'
   four epochs of 8000 until phase 32 joined) through ``train_mlp``:
   per-epoch accuracy beside
   the reference's documented figures, wall seconds, steps/s, profiled
   device ms per step and the reads' share; each run's launches counted
   and gated; the paper's claim lines printed, not gated.  (c) the port's
   ``hwmodel`` headline and phase 7's projected pJ per MAC.

15. gemma-2b at full size (all 18 layers, full widths: 1.98 B cells in
   each of ``g`` and ``ref``, 34 GB resident with ``g_target`` and the
   tied embedding) programmed from random weights (torch.Generator seed
   0) onto ``taox-nonoise`` 64x64 tiles, 8-bit DAC/ADC, dynamic range,
   and served by the continuous scheduler (4 slots, prefill chunk 16, 4
   prompts of 8-16 tokens, 32 greedy tokens) under
   ``RetentionSpec(nu=0.05, nu_sigma=0.5)``: serve; ``advance_clock(3
   days)`` (the drift timed alone) and serve; ``start_recalibration()``
   drained through serving ticks while a request decodes; serve.  Gates:
   4 reads a layer per model call in every serve, all on the FP32
   instance with its K-order sum; every read of a prefill and a decode
   call against its plain version on its own operands (phase 1's bound);
   layer 0 of ``wo`` drifted on the card within 1e-6 relative of the same
   drift on the CPU; the drifted tokens or logits differ from the first
   serve's; the sweep takes one tick per container (4), restores every
   ``g`` and ``ref`` to ``g_target`` bit for bit, bills pulses and resets
   the ages, and the restored tokens equal the first serve's exactly.
   Tokens/s, the profiled decode step, drift and sweep ms, peak memory
   and the energy per token are reported.
16. (a) stablelm-3b and granite-20b at full width cut to 2 layers, served
   with phase 15's settings (8 new tokens): phase 15's read gates.  (b)
   starcoder2-3b at full width cut to 2 layers, one device-mode training
   step (TaOx, lr 0.1, 8 x 256 tokens): 8 forward and 8 transpose reads
   on the tensor-core instance, 4 tensor-core writes with their
   pre-passes; every launch against its plain version on its own
   operands (phase 7's classes).
17. QAT: lm100m at full width in fakequant mode (1024-row tiles, 8-bit),
   4 steps of ``train_loop.make_train_step(cfg, adamw(3e-4))`` on 8 x 256
   tokens.  Gates: each step launches the tensor-core fakequant read 48
   times (with its pre-pass and epilogue, nothing of the FP32 instance),
   runs no plain version forward, and recomputes the eager expression 48
   times in the backward (``kernels.ops.FakequantRead``); on step 1's
   state every read against the plain version on its own operands
   (phase 8's bound) and the loss gradient within 1e-4 relative in
   2-norm per leaf of the eager graph's carrying the kernel's forward
   values; the backward's recomputed ADC lsb (``kernels.ops._adc_lsb``,
   48 ranges a step) equal to the float32 division ``sat / out_levels``
   bit for bit; finite losses.  The gradient of the free-running eager
   forward and the code flips between the two forwards are reported:
   the reference's gradient has no straight-through estimator, so an
   activation's gradient reaches it only through the DAC scale's argmax
   element, and one flip moves a whole leaf's gradient.

18. the MoE family: llama4-scout-17b-a16e at full width (d 5120, 16
   experts of 5120 x 8192, top-1, one shared expert, vocab 202048) cut
   to 2 of 48 layers, random weights from torch.Generator seed 0.  (a)
   From expert-batched ``taox-nonoise`` 64x64 crossbars (8-bit DAC/ADC,
   dynamic range) with phase 15's serving settings, 16 greedy tokens:
   7 reads a layer per model call (wqkv, wo, the shared w_upgate and
   w_down, one read of each (16, K, N) expert stack), all on the FP32
   instance with its K-order sum; every read of a prefill and a decode
   call against its plain version on its own operands, one expert at a
   time, its DAC scales bit-equal to the float32 division, and at least
   one expert that read an all-zero buffer returning exact zeros; the
   prefill logits against a CPU run with the card's reads and routing
   replayed (the CPU router's own differing choices counted), within
   1e-3.  Tokens/s, the profiled decode step with the expert reads'
   CUDA-event time against their bytes, peak memory.  (b) kernel 4 with
   its lead dim: stacks of exact-class operands (bit-equal, both
   instances) and llama4-scout's expert stacks at capacity 8 (FP32, 12
   of 16 experts all-zero) and 160 (tensor cores), each read one launch
   of each of its three kernels, every expert against the plain version
   (phase 8's bound), timed; then the model in fakequant mode served as
   (a): 7 fakequant reads a layer a call (3 of expert stacks), one launch
   of each kernel a read, no plain version on the card, every read of a
   prefill and a decode call held per expert.  (c) one device-mode
   training step (TaOx, lr 0.1, 8 x 256 tokens, capacity 160) at 1 layer
   (2 do not fit the card's memory): 7 + 7 tensor-core reads and 7
   tensor-core writes with their pre-passes, each expert stack's write
   one launch over (16 L, K, N); every read per expert and every write
   per flattened layer (its noise field recomputed for that layer)
   against its plain version (phase 7's classes); routed pairs dropped
   by capacity, the profiled step by kernel, peak memory.

19. MLA: deepseek-v2-lite-16b at full width (d 2048, 16 heads, q/k head
   192 = 128 nope + 64 rope, v head 128, kv_lora 512; 64 experts of 2048
   x 1408, top-6, two shared experts; vocab 102400), random weights from
   torch.Generator seed 0.  (a) 4 of 27 layers from expert-batched
   ``taox-nonoise`` 64x64 crossbars with phase 15's serving settings
   (``max_len`` 64), 16 greedy tokens: 9 reads a layer a call (wq,
   wkv_a, wkv_b, wo, the shared w_upgate and w_down, the three (64, K,
   N) expert stacks), ``wkv_b`` on the tensor-core instance (it
   re-expands the whole latent cache: 64 rows a prefill chunk, 4 x 64 a
   decode call), the rest on the FP32 instance with its K-order sum; one
   scheduler tick (a prefill chunk and a decode call) with every read
   held on its own operands one expert at a time, each ``wkv_b`` read B
   x ``max_len`` rows on the tensor cores, an expert with no token
   reading exact zeros; the chunk's logits against a CPU run with the
   card's reads and routing replayed, within 1e-3.  Tokens/s, the share
   of expert reads with an all-zero buffer, the profiled decode step and
   the expert reads' CUDA-event time against their bytes, resident and
   peak memory.  (b) the same depth in fakequant mode served as (a): 9
   fakequant reads a layer a call, one launch of each kernel a read,
   ``wkv_b`` at decode (256 tokens) on the tensor-core instance, no
   plain version; a (4, 12) prefill, a decode step and a decode step
   with ``REPRO_MLA_ABSORB=1`` (no ``wkv_b`` read; the variable restored
   after it), every read held per lead matrix, the three calls' logits
   against a CPU run with the card's reads and routing replayed, within
   1e-3.  (c) one device-mode training step (TaOx, lr 0.1, 8 x 256
   tokens, capacity 240) at 2 layers, as 18(c): 9 + 9 tensor-core reads
   a layer, 9 tensor-core writes (3 over (64 L, K, N) expert stacks),
   every read per expert and every write per flattened layer against its
   plain version.

20. the SSM family: mamba2-1.3b at full size (48 SSD layers, d 2048,
   state 128, vocab 50288, tied embedding; 1.24 B cells in each of
   ``g`` and ``ref``), random weights from torch.Generator seed 0.  (a)
   From ``taox-nonoise`` 64x64 crossbars (8-bit, dynamic range) served by
   the static scheduler (the family has no positional cache per slot): 4
   prompts of 8-16 tokens left-padded with 0, 16 greedy tokens.  Gates:
   96 reads a model call (``in_proj`` and ``out_proj`` a layer), the
   prefill's on the tensor-core instance with its pre-pass and range
   pass, each decode call's on the FP32 instance with its K-order sum;
   every read of a left-padded prefill and a decode step against its
   plain version on its own operands (phase 1's bound), its DAC scale
   the float32 division; the prefill's logits within 1e-3 and every
   layer's final SSM state ``h`` within 1e-3 of the largest |h| of a CPU
   run with the card's reads replayed.  Tokens/s, the profiled decode
   step and its reads against their bytes, resident and peak memory.
   (b) in fakequant mode (1024-row tiles, 8-bit) served alike: 96
   fakequant reads a call, each one launch of each FP32-instance kernel
   (no read reaches 144 tokens), no plain version on the card; a prefill
   and a decode step held read by read (phase 8's bound), the prefill's
   logits within 1e-3 of a CPU replay.  (c) one TaOx step (lr 0.1, 8 x
   256 tokens) at 8 of 48 layers: 16 forward and 16 transpose reads on
   the tensor-core instance, 2 writes on the tensor-core instance, each
   over an (8, K, N) stack, none on the FP32 instance; every read and
   write against its plain version on its own operands (phase 7's
   classes).  The profiled step by kernel group, the SSD scan's own
   device time (fwd + bwd, alone, at the step's shapes) and peak memory.
21. the hybrid family: zamba2-1.2b at full size (38 SSD layers and a
   shared attention block after every 6: 32 heads of 64, GeGLU d_ff
   8192; 1.05 B cells).  (a) served as 20(a): 106 reads a model call (the
   shared block's five containers once an application, 6 a call); the
   same gates.  (b) the FP32 write instance at the shared ``w_upgate``
   (2048 x 16384) over 2 x 2048 rows on an ideal device with
   power-of-two scales: bit-equal to its plain version; then one TaOx
   step at 13 of 38 layers (two groups and their shared-block
   applications, one trailing layer): 36 + 36 tensor-core reads, the two
   SSD stacks written on the tensor-core instance, the shared block's
   five containers each written once on the FP32 instance over their two
   applications' 2 x 2048 rows (float operands: every application's
   codes have their own scale); each application's tape slot distinct,
   with its own code scales; every tensor-core write in
   ``tc_write_agrees``'s class, every FP32-instance write within
   ``update_bound`` of its plain version fed the same tapes.

22. the audio encoder-decoder: whisper-medium at full width cut to
   ``AUDIO_LAYERS`` (8) of its 24 encoder and 24 decoder layers (d 1024,
   16 heads of 64, d_ff 4096 GELU, 1500 frames, vocab 51872; 704.6 M
   cells uncut; the cut keeps the script in its time limit since phase
   29), random weights from
   torch.Generator seed 0, the frames seeded normals (B, 1500, 1024).
   (a) From ``taox-nonoise`` 64x64 crossbars served by the static
   scheduler with the frames as ``extras``: 4 prompts of 8-16 tokens, 16
   greedy tokens.  Gates: the prefill reads the 96 encoder containers
   over 4 x 1500 rows and the decoder ones (the cross ``wqkv`` over
   the prompt rows and the 6000 frame rows in one read), all on the
   tensor-core instance; each decode call reads the decoder
   containers over 4 rows on the FP32 instance with its K-order sum and
   no encoder container; every read of a prefill and a decode step
   against its plain version on its own operands (phase 1's bound), its
   DAC scale the float32 division; both calls' logits within 1e-3 of a
   CPU run with the card's reads replayed.  Tokens/s, the profiled
   decode step, its reads' CUDA-event time against their 3.22 GB byte
   bound, resident and peak memory.  (b) in fakequant mode (1024-row
   tiles, 8-bit) served alike: each read on the instance its rows pick
   (the encoder's 6000 rows and the cross ``wqkv``'s on the tensor-core
   one), one launch of each of its kernels, no plain version on the card;
   a prefill and a decode step held read by read (phase 8's bound),
   logits within 1e-3 of a CPU replay.  (c) one TaOx step (lr 0.1, 4 x
   128 tokens with 4 x 1500 frames): every container read forward and
   back on the tensor cores and 10 writes with their pre-passes (the encoder's
   four stacks over 6000 rows, the cross ``wqkv`` over 512 + 6000); each
   container's tapes one block a layer of its operand rows, its
   cotangent non-zero in every layer, no read of zeros; every read and
   write against its plain version on its own operands (phase 7's
   classes); the profiled step by kernel group, peak memory.
23. the VLM: llama-3.2-vision-90b at full width (d 8192, 64 heads of 128,
   8 KV heads, d_ff 28672, vocab 128256, 1024 vision tokens, a gated
   cross layer every 5th) cut to its first group: 5 of 100 layers (the
   cross layer and its four self layers; 855.6 M cells a layer, 684 GB of
   ``g`` + ``ref`` at 100), the vision tokens seeded normals, the cross
   gates set to 0.5 and 0.75 in every tree (the reference's 0 hides the
   cross blocks and zeroes their containers' cotangents).  (a) From
   crossbars served as 22(a) (about 77 GB resident with the programming
   targets): 20 reads a call; the cross ``wqkv`` reads the prompt or the
   decode token and all 1024 vision rows (4 x 1025 a decode call) on the
   tensor-core instance, the other 19 of a decode call on the FP32 one;
   the same read and replay gates; the cross read's CUDA-event time
   beside the other reads'.  (b) in fakequant mode at 10 layers (two
   groups), served as 22(b).  (c) one TaOx step at 5 layers, 2 x 128
   tokens with 2 x 1024 vision rows: 20 + 20 tensor-core reads, 8
   tensor-core writes, the cross ``wqkv`` over 256 + 2048 rows; as 22(c).
24. the sharded train step's kernel work, each shard of a layout in turn
   on this one card (the step itself runs on gloo CPU ranks in the tests;
   a run across four cards is not made here).  (a) lm100m's four
   containers at full width, (12, K, N) with T = 2048, codes times scales
   and TaOx counter-PRNG noise, cut into the blocks the policy gives them
   (``launch.sharding.analog_update_specs``) on 2x4 and 4x4 layouts, and
   one llama4-scout-17b-a16e expert stack at 1 layer with its 16 experts
   over 4 shards: each block written alone at its (layer, row-tile,
   col-tile) offsets on the tensor-core and the FP32 instance, outer and
   pulse-train, with the container's code scales.  Gates: the blocks
   reassemble bit-equal to the whole write; each block against its plain
   versions at its offsets (``tc_write_agrees``, ``update_bound``,
   ``pulse_agrees``); each instance's launches counted; in outer mode a
   block at other offsets draws other noise.  (b) the same containers and
   layouts, forward and transpose, at B = 4 (FP32 instance) and B = 2048
   (tensor cores), and the expert stack at its capacity buffer: every
   rank of the layout, emulated one after another on the card
   (``launch.mesh.emulate_layout``), runs the sharded step's read
   ``kernels.xbar_vmm.manual_collective_read`` on its block: its
   reduction rows of the drive at the whole drive's DAC scale, read in
   partials form, the partials gathered in tile order
   (``core.shardctx.combine_partials_exact``) and summed by
   ``reduce_tiles_kernel``, the output and expert blocks gathered.
   Gates: every rank's result bit-equal to the whole read; one read
   launch a rank, and one tile sum a rank where the reduction dim is
   split.  The whole read's and the emulated layout's CUDA-event times,
   beside the card's name and power limit.  (c) the training CLI under
   ``torchrun`` in a one-rank NCCL group, lm100m at full width with
   ``--analog`` (QAT: kernel 4 under autograd) and ``--grad-compress``,
   6 steps with a checkpoint at 4, then a second run resumed from step 4.
   Gates: steps 5-6 take the same batches and their losses agree within
   1e-6 relative; every step reads through the fakequant kernel, the
   same count each step.  Tokens/s.
25. the port's auditor, oracle and dry run against the card.  (a) the
   bit-plane oracle: both read kernels, forward and transpose, on the
   FP32 instance (B = 4) and the tensor-core one (B = 64), at lm100m's
   four container shapes and a ragged 200 x 72 (64x64 tiles), with 2, 4,
   8 and 9-bit DACs (9: the widest the tensor-core instance takes): an
   ideal device, conductances 0.5 + j/8 against a reference of 0.5, DAC
   codes pinned to their grid (the DAC scale 1), a 16-bit ADC at a fixed
   range whose lsb is 1/8.  Gates: every read, and the plain read, bit-
   equal to ``kernels.ref.vmm_bitplanes`` computed on the card in
   float32 (every charge an exact float32 sum).  (b) launch coverage:
   ``analysis.kernel_lint.audit_launches`` runs kernels 1, 2 (both
   instances, the partials form with its tile sum), 3 and 3p (both write
   instances), 4 (both instances, an expert stack) and 5 (float32 and
   bfloat16) on ragged shapes (partial tiles in every tiled dim) and at
   lm100m's full width, each output allocated through the wrappers' hook
   (``kernels.outputs``) as a NaN sentinel between two guard regions.
   Gates: no sentinel left (RA201), no guard element changed (RA202), two
   launches bit-equal (RA201).  (c) ``launch.dryrun.reckon`` of two
   lm100m train steps at 8 x 256 tokens on meta tensors, each against
   the same step on the card: the QAT step (phase 17's cell) and the
   digital bfloat16 step (the mode of the dry run's table).  Gates: the
   reckoned argument bytes equal the bytes of the state and batch
   allocated on the card; a finite loss; the card's peak over the step
   (``torch.cuda.max_memory_allocated``) within 0.9-1.1 of the reckoned
   peak (the same ops and autograd structure on meta and on the card).

Phases 1-25 run under ``REPRO_REMAT=none`` (no per-layer remat), so
their gates, launch counts and times stay comparable with the runs
before remat existed.

26. per-layer remat (``models.transformer._remat``, ``REPRO_REMAT``:
   ``full``, the default, and ``dots`` against ``none``).  (a) lm100m in
   device mode with phase 7's settings, one step under each policy from
   one state with one ``seed_base``: the new conductances, digital leaves
   and loss bit-equal across the policies (a digital leaf passes
   otherwise only where ``none`` does not reproduce itself on the card,
   and then within phase 7's CPU-replay class); 48 forward reads, 48
   transpose reads and 4 writes under ``none``, 48 more forward reads
   (the backward's recompute) under ``full`` and ``dots``; each policy's
   ``max_memory_allocated``.  (b) 25(c)'s QAT and digital cells under
   each policy: 25(c)'s gates with the dry run reckoned under the same
   policy (the card's peak within 0.9-1.1), the parameters after the
   step bit-equal to ``none``'s, kernel 4's tensor-core instance 48
   reads a QAT step under ``none`` and 96 under ``full`` / ``dots``.
   (c) starcoder2-3b at full size (30 of 30 layers) in device mode, one
   step over 1 x 4096 tokens under ``full`` (1 x 2048 if it does not
   fit, said so): a finite loss, the conductances in the window, 240
   forward reads (120 recomputed), 120 transpose reads and 4 writes on
   the tensor-core instances, the first and last layers' reads and
   writes against their plain versions (phase 7's classes) and each
   recomputed read bit-equal to its original; the step ms and the card's
   peak beside the dry run's reckoning of the same step under ``none``
   and ``full``.  (d) zamba2-1.2b at 21(b)'s 13-layer cut, one step
   under ``none`` and ``full``: bit-equal as (a), the 26 SSD layers'
   forward reads made once more, the shared block's not.  (e) the
   prefill head: ``models.model.prefill``'s last-position logits against
   the full forward's last row, lm100m and starcoder2-3b (2 layers),
   float32 (within 1e-5) and bfloat16 (stated).

27. FSDP and tensor parallelism of the numeric step, and the analog
   step's ``exact=False``.  Each rank of a layout runs as its own process
   on this one card, in a gloo group whose collectives move through
   slots on the card that every rank maps by CUDA IPC
   (:class:`CardTransport`, the meshes' exchange hook).  (a) lm100m at
   full width cut to 6 of its 12 layers (since phase 30, for the time
   limit), QAT at 128-row tiles (so that ``wo`` and ``w_down`` split
   by rows), 8 x 256 tokens, one step on 2x2, 1x4 and 4x1 against
   the 1x1 step from the same state: the loss within 1e-4, the
   parameters in the test class, the fakequant reads a rank equal to the
   1x1 step's; on ``model`` ranks kernel 4's split-range (column split)
   and tiles (row split) reads against their plain versions and bit-equal
   to the whole read, both launched by the step.  (b) gemma-2b at full
   width cut to 3 of 18 layers (6 since phase 29, 3 since phase 30, for
   the time limit),
   digital bfloat16, FSDP on 4x1 over 4 x 1024 tokens: each rank's held
   bytes equal the dry run's policy bytes, two layer gathers a layer, the
   loss within bfloat16's class of the 1x1 forward's.  (c)
   ``exact=False`` on 2x4 (lm100m, device mode, phase 7's settings):
   every read of the four containers within the reassociation bound of
   the exact read, the step's first read too, and off it when one rank's
   tile sum is dropped (a planted fault); the write's distance from the
   exact step's against the spread of one-ulp embedding nudges.

28. Tensor and expert parallelism of the MoE family, each rank its own
   process on this card as in phase 27.  (a) deepseek-v2-lite at full
   width cut to 1 layer (2 before phase 30, cut for the time limit), QAT
   at 128-row tiles, 8 x 256 tokens, one step
   on 2x2, 1x4 and 4x1 against the 1x1 step from the same state: the loss
   within 1e-4, the parameters in the test class, each data rank's
   expert-stack read (kernel 4's lead form with the DAC scales shared
   over the data ranks) bit-equal to the whole buffer's read at the same
   rows and against its plain version, MLA's split (``wq``) and tiles
   (``wo``) reads bit-equal to the whole read, each rank's fakequant and
   expert-stack reads equal to the 1x1 step's, no plain-version call,
   the plan's flags.  (b) llama4-scout at full width, one layer, digital
   bfloat16 with sgd, on 1x4 over 4 x 1024 tokens: each rank's held
   parameter bytes equal the dry run's policy bytes, the loss within
   1e-2 of the 1x1 forward's, 2 layer gathers.  (c) (a)'s cut on 4x1 at
   capacity factor 1.0, where the 1x1 forward drops pairs: the loss
   within 1e-4 and the ranks' dropped pairs summing to the 1x1 count.

29. Tensor parallelism of the SSM, hybrid and cross-attention families,
   each rank its own process on this card as in phase 27.  (a)
   mamba2-1.3b at full width cut to 2 layers, (b) zamba2-1.2b cut to 6
   (one application of the shared block), (c) whisper-medium cut to 2
   encoder and 2 decoder layers (over 8 x 1500 frames), each QAT at
   128-row tiles, 8 x 256 tokens, one adamw step on 2x2, 1x4 and 4x1
   against the 1x1 step from the same state: the loss within 1e-4, the
   parameters in the test class, each rank's fakequant reads equal to the
   1x1 step's (split-range and tiles reads among them on ``model``
   ranks), no plain-version call, the plan's flags and the SSD norm's
   gather counted; on ``model`` ranks ``in_proj``'s split read (B, C and
   dt whole on every rank), ``out_proj``'s tiles read, the shared block's
   ``wqkv`` / ``w_upgate`` split and ``wo`` / ``w_down`` tiles reads and
   the cross ``wqkv``'s split read over a sequence's 256 + 1500 rows,
   each bit-equal to the whole read and against its plain version, and
   the scan probe (the SSD scan on the rank's heads against the
   all-heads scan's, forward and backward) bit-equal.  (d)
   llama-3.2-vision-90b at full width cut to 5 layers (a cross block and
   four self blocks), digital bfloat16 with sgd, on 1x4 over 4 x 1024
   tokens and 1024 vision tokens, the cross gates non-zero: each rank's
   held parameter bytes equal the dry run's reckoning, the loss within
   1e-2 of the 1x1 forward's, the layer gathers counted.
30. ``REPRO_SEQ_SHARD`` (the sequence split over ``model`` between the
   blocks) on the other families, each rank its own process on this card
   as in phase 27: (a) phase 28(a)'s deepseek-v2-lite on 2x2 and 1x4,
   (b)-(d) phase 29(a)-(c)'s mamba2, zamba2 and whisper on 1x4, each one
   QAT step against the 1x1 step of phases 28-29 (whose parameters they
   keep for this phase) and against the same layout's step without the
   flag: ``seq`` on, each column-parallel read's input the tokens' (and
   the frames') chunk gathered whole, the loss within 1e-4, the
   parameters in the test class, each rank's fakequant, split, tiles and
   expert reads equal to the layout's count without the flag, no
   plain-version call, and the reads of a whole leaf on a chunk (MLA's
   ``wkv_a``, the hybrid's shared ``in``: the DAC scale shared over
   ``model``) bit-equal to their rows of the whole read; (e) phase 29(d)'s
   VLM step under the flag, its loss within 1e-2 of the 1x1 forward's.
   Printed beside the layouts without the flag: the bytes each rank
   receives a step through the numeric step's collectives, peak GB and
   step ms a rank.
31. The reference's last public entry points, in the main process at
   lm100m's full-width container shapes (12, 768, 2304) and (12, 3072,
   768), 64x64 tiles: (a) with ``stochastic_round=True`` the forward and
   transpose reads at B = 4 (FP32 instance) and B = 2048 (tensor-core
   instance) and the fakequant read at T = 4 and T = 2048 (one layer's
   matrix, 1024-row tiles) bit-equal to the same reads with the flag off
   (no library read passes a uniform field, as no reference read passes a
   key); (b) ``kind="lut"`` writes, outer and pulse-train, on the
   tensor-core and FP32 instances at T = 2048 with counter-PRNG noise,
   bit-equal to ``kind="taox"`` at the same seed; (c)
   ``kernels.ops.outer_update`` (float operands quantised on the card,
   then the tensor-core write) in host and kernel noise modes within the
   write's class of its plain version (``tc_write_agrees``), one
   tensor-core write and one pre-pass a call, its CUDA-event ms printed
   beside the direct ``xbar_outer_update`` of the same quantised
   operands; (d) ``kernels.ops.vmm`` / ``mvm`` bit-equal to
   ``core.xbar_ops.vmm`` / ``mvm`` at both batch sizes.  Every gate counts
   its kernels' launches.
32. Serving under the sharding policy (``models.model.prefill`` /
   ``decode_step`` with ``mesh=``, ``launch.sharding.ServeParallel``),
   float32, digital and fakequant (128-row tiles): (a) before phase 27,
   the decode attention's chunk sum on the card (one cumsum) bit-equal to
   the chunks added in order; gemma-2b (18 layers, vocab 256000),
   mamba2-1.3b (48) and zamba2-1.2b served on this card alone, a prefill
   of 4 x 1024 tokens into a 1040-slot cache and ``SERVE_STEPS`` greedy
   decode steps (16 gemma-2b, 3 the others), their logits and tokens
   kept under build/ and the models freed; (b) in phase 27(a)'s rank
   processes, each model drawn whole one rank at a time and cut into
   each layout's serving blocks, then served on its layouts (gemma-2b
   1x4, where its one kv head puts the cache along the sequence, 2x2 and
   4x1; mamba2 1x4 and 4x1; zamba2 1x4) with the same prompts, each rank
   its rows, each decode step fed the one-device run's greedy token:
   each rank's held parameter and cache bytes equal the dry
   run's (``launch.dryrun.serving_state``) at its coordinates, gemma-2b's
   the policy's exactly and the SSM family's beyond it only the named
   whole parts; the logits of the prefill and of every step finite and
   within ``SERVE_CLASS`` of the one-device run's; the same greedy
   tokens but where the one-device run's top two lie within
   ``SERVE_TIE`` classes of the step's scale; in fakequant mode every
   shared DAC scale the max of its ranks' own (checked apart from the
   read's reduce) and on data ranks one a read; gemma-2b's 4x1 served
   once more with a planted fault (each data rank's scale over its own
   rows), which that gate must catch, its logits' reading printed;
   gemma-2b's sequence-split decode attention once a layer a step on
   1x4 and 2x2; in fakequant mode no plain-version call, a decode step's
   reads the one-device step's, on ``model`` ranks its column splits on
   kernel 4's split form and its row splits on the tiles form; kernel
   4's split and tiles forms at 4 decode rows (gemma-2b's ``wqkv`` by
   its parts, its ``w_down`` by row tiles) against their plain versions
   and bit-equal to the whole read, timed beside the whole read.
   Printed: prefill ms and decode ms a step per rank (events), held GB
   per rank, the bytes a rank receives through the collectives a decode
   step.

Every phase prints its wall seconds on a line of its own.

Every read's DAC scale (phases 1, 3, 4, 7, 14, 15, 16, 18-23) must
equal the float32 division ``max|x| / in_levels`` bit for bit.

The second-to-last line is a JSON object with each kernel's launches,
error and times; the last is ``{"ok": true, "device": {...}}``.  Details
go to ``chiprun_out/chip_smoke.json``.
"""
import collections
import contextlib
import inspect
import itertools
import json
import math
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS = 67e12            # H100 SXM data sheet, FP32 outside tensor cores
BF16_FLOPS = 989e12           # H100 SXM data sheet, dense bf16 tensor cores
TF32_FLOPS = 495e12           # H100 SXM data sheet, dense TF32 tensor cores
L2_BYTES = 50e6


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def kernel_us(prof):
    """Device time, in µs, of the kernels a torch.profiler run recorded
    (kernel events only: an operator's own device time repeats its
    kernels')."""
    from torch.autograd import DeviceType
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU)


def per_call_us(events, n_iter):
    """Device time per call, in µs, of the kernel events ``events`` a
    profiler run of ``n_iter`` calls recorded: each kernel's mean event
    time times its launches per call, taken as ceil(count / n_iter).  The
    profiler drops a kernel event now and then (3 of 5 recorded in PR 14's
    phase 12), and a total divided by ``n_iter`` would then read short."""
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               / e.count * math.ceil(e.count / n_iter)
               for e in events if e.count)


def device_ms(fn, n_iter, split=None):
    """Kernel time per call of ``fn`` on the card, from torch.profiler
    (the launches' host overhead is left out; see :func:`per_call_us`);
    None if the profiler recorded no kernel.  With ``split`` (names), also
    the time per call of the kernels whose names contain each name:
    ``(ms, {name: ms})``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_iter):
            fn(i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU]
    us = per_call_us(kernels, n_iter)
    ms = us / 1e3 if us > 0 else None
    if split is None:
        return ms
    parts = {name: per_call_us([e for e in kernels if name in e.key],
                               n_iter) / 1e3 for name in split}
    return ms, parts


def profiler_warmup():
    """A first, discarded profiler session: a short first session can come
    back without device events while the tracer starts up."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn((1024, 1024), device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(100):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def cuda_ms(fn, n_iter, sync):
    fn(0)
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    sync()
    return start.elapsed_time(end) / n_iter


def make_operands(k, n, b, gen, grid, device):
    """Conductances programmed from normal weights (window [0, 1], reference
    at the midpoint), on the 1/256 pulse grid when ``grid``."""
    w = torch.randn((k, n), generator=gen, device=device) / math.sqrt(k)
    w_max = w.abs().amax()
    g = 0.5 + w * (0.5 / w_max)
    if grid:
        g = torch.round(g * 256.0) / 256.0
    ref = torch.full_like(g, 0.5)
    x = torch.randn((1, b, k), generator=gen, device=device)
    return x, g[None].contiguous(), ref[None].contiguous(), (0.5 / w_max)[None]


def tile_lsb(x, g, ref, sc, cfg, transpose=False):
    """Per-(reduction tile, output tile) ADC lsb of a read, from the plain
    pieces: (K tiles, N tiles) forward, (N tiles, K tiles) transposed."""
    from repro_torch.core.adc import _clip, _round, integrator_saturation
    lv = float(cfg.adc.in_levels)
    xi = _clip(_round(x / sc[:, 0, None, None]), -lv, lv)[0]
    k, n = g.shape[-2:]
    diff = torch.nn.functional.pad(g[0] - ref[0], (0, (-n) % cfg.cols,
                                                   0, (-k) % cfg.rows))
    rows, cols = cfg.rows, cfg.cols
    if transpose:
        rows, cols, diff = cols, rows, diff.T
    xi = torch.nn.functional.pad(xi, (0, diff.shape[0] - xi.shape[1]))
    tr, to = diff.shape[0] // rows, diff.shape[1] // cols
    q = torch.einsum("btr,trnc->btnc", xi.reshape(-1, tr, rows),
                     diff.reshape(tr, rows, to, cols))
    _, sat = integrator_saturation(q, cfg.adc, rows, cfg.device.gmax,
                                   reduce_axes=(0, 3))
    return sat[0, :, :, 0] / cfg.adc.out_levels


@contextlib.contextmanager
def recording_reads(K, reads, host=False):
    """Record every read the kernels run, with its operands and result:
    ``(x, g, ref, sc, cfg, y, transpose)``; with ``host``, ``x``, ``sc``
    and ``y`` are kept in host memory (whisper's step reads 480 times over
    up to 6512 rows: 25 GB of copies)."""
    read_cuda = K._read_cuda

    def keep(t):
        return t.cpu() if host else t.clone()

    def recorded(x, g, ref, sc, cfg, transpose=False):
        y = read_cuda(x, g, ref, sc, cfg, transpose)
        reads.append((keep(x), g, ref, keep(sc), cfg, keep(y), transpose))
        return y

    K._read_cuda = recorded
    try:
        yield
    finally:
        K._read_cuda = read_cuda


#: Output columns (whole tiles) a plain-version check of a read forms at
#: once: each output tile's charges and range depend on its own columns
#: only, so the check runs in slices of this many and its temporaries
#: stay a few GB at B = 2048; fewer where a column's charges (B x the
#: reduction tiles) would put more than ``CHECK_ELEMS`` in a slice (the
#: VLM's cross ``wqkv`` reads 4 x 1025 rows over 128 K tiles).
CHECK_COLS = 2048
CHECK_ELEMS = 2 ** 27


def out_chunks(n_out, width, per_col=1):
    """``(c0, c1)`` slices of a read's ``n_out`` outputs, whole tiles of
    ``width`` each, at most about ``CHECK_COLS`` wide and about
    ``CHECK_ELEMS / per_col`` (``per_col`` the charges a column forms)."""
    step = max(width, min(CHECK_COLS, CHECK_ELEMS // per_col)
               // width * width)
    return [(c, min(c + step, n_out)) for c in range(0, n_out, step)]


def charges_per_col(x, g, cfg, transpose):
    """Tile charges one output column of a read forms: B x the reduction
    tiles (rows of ``g`` forward, columns transposed)."""
    n_red, tile = (g.shape[2], cfg.cols) if transpose \
        else (g.shape[1], cfg.rows)
    return x.shape[1] * -(-n_red // tile)


def out_slice(g, c0, c1, transpose):
    """The conductances behind outputs ``c0:c1`` of a read of ``g`` (L, K,
    N): columns forward, rows transposed."""
    return g[:, c0:c1, :] if transpose else g[:, :, c0:c1]


def plain_read(K, x, g, ref, sc, cfg, transpose):
    """The plain version of a read, formed one slice of output tiles at a
    time (:func:`out_chunks`)."""
    width = cfg.rows if transpose else cfg.cols
    n_out = g.shape[1] if transpose else g.shape[2]
    return torch.cat([K._read_plain(x, out_slice(g, c0, c1, transpose),
                                    out_slice(ref, c0, c1, transpose), sc,
                                    cfg, transpose)
                      for c0, c1 in out_chunks(
                          n_out, width, charges_per_col(x, g, cfg,
                                                        transpose))], dim=-1)


#: Reads whose flip share reached 1% and was taken again with the tiles
#: that match a tie recount (:func:`tie_recount`): one dict a read with
#: its x shape, the output tiles tried and accepted, the outputs whose
#: errors were taken against the recount, and the share before and after.
TIE_RECOUNTS = []

#: Most tie-count combinations a tile is recounted under; a tile with more
#: is not recounted and stays in the share as it is.
MAX_RECOUNTS = 256


def tie_recount(y_k, x, g, ref, sc, cfg, transpose, tile, thresh):
    """The kernel's outputs of one output ``tile`` of one lead matrix's
    read, held against the plain read recounted at its zero ties: the
    fewest outputs more than ``thresh`` off, and how many there are.

    The dynamic range is the rms over a tile's non-zero charges
    (``core.adc.integrator_saturation``), so a charge that one float32
    summation order gives as exactly 0 and another as a rounding residual
    changes the tile's count of non-zero charges by one, its lsb by about
    0.2% at 256 charges, and every output of the output tile with it.  A
    charge is tied when it lies within the recursive-sum bound of 0,
    ``|q| <= rows * 2^-24 * sum |x_i d_i|`` (float64), so that some order
    may give either.  The plain read is formed again from the exact
    charges rounded to float32, once for every count of non-zero charges
    the ties allow in each reduction tile (a tied charge counted as 0 or
    as its residual), and the best match is returned.  Returns ``None``
    when the tile has no tie or more than ``MAX_RECOUNTS`` counts."""
    from repro_torch.core.adc import (_clip, _round, adc_quantize,
                                      integrator_saturation)
    lv = float(cfg.adc.in_levels)
    xi = _clip(_round(x[0] / sc[0, 0]), -lv, lv).double()
    rows, cols = cfg.rows, cfg.cols
    d = (g[0] - ref[0]).double()
    if transpose:
        rows, cols, d = cols, rows, d.T
    c0, c1 = tile * cols, min((tile + 1) * cols, d.shape[1])
    kp = -(-d.shape[0] // rows) * rows
    d = torch.nn.functional.pad(d[:, c0:c1], (0, 0, 0, kp - d.shape[0]))
    xt = torch.nn.functional.pad(xi, (0, kp - xi.shape[1])).reshape(
        xi.shape[0], kp // rows, rows)
    dt = d.reshape(kp // rows, rows, c1 - c0)
    q = torch.einsum("btr,trc->btc", xt, dt)
    s = torch.einsum("btr,trc->btc", xt.abs(), dt.abs())
    tied = (s > 0) & (q.abs() <= rows * 2.0 ** -24 * s)
    if not tied.any():
        return None
    resid = torch.where(q != 0, q, 2.0 ** -24 * s).float()
    q32 = torch.where(tied, torch.zeros_like(resid), q.float())
    where = [tied[:, t].nonzero().tolist() for t in range(tied.shape[1])]
    counts = [range(len(w) + 1) if w else range(1) for w in where]
    if math.prod(len(c) for c in counts) > MAX_RECOUNTS:
        return None
    best = None
    for combo in itertools.product(*counts):
        qa = q32.clone()
        for t, n in enumerate(combo):
            for b, c in where[t][:n]:
                qa[b, t, c] = resid[b, t, c]
        qc, sat = integrator_saturation(qa[:, :, None, :], cfg.adc, rows,
                                        cfg.device.gmax, reduce_axes=(0, 3))
        y_alt = adc_quantize(qc, sat, cfg.adc).sum(dim=1)[:, 0, :] \
            * sc[0, 1]
        off = (y_k[0, :, c0:c1] - y_alt).abs() > thresh
        if best is None or off.sum() < best.sum():
            best = off
    return best


def read_agrees(y_k, y_p, x, g, ref, sc, cfg, transpose=False):
    """The dynamic-class bound: every element within one ADC lsb per
    reduction tile (times the output scale) of the plain version, plus
    1e-5 of the larger of the two values, and under 1% of the elements
    more than 1e-5 relative off.  Where the share reaches 1%, each output
    tile with off elements is held against the plain read recounted at
    its zero ties (:func:`tie_recount`), and its elements count in the
    share by their errors against the recount where it leaves fewer off;
    such reads are listed in ``TIE_RECOUNTS``.  The relative term is
    taken of both values, as in :func:`fq_agrees`, so that it also covers
    a code that flips between 0 and +-1, where the plain value is 0 and
    the kernel's is one lsb of its own (its range sum taken in another
    order).  Each lead matrix (an expert of a stack) has its own lsb and
    scale.  Returns (ok, max abs err, largest err / bound, flip share)."""
    err = (y_k - y_p).abs()
    width = cfg.rows if transpose else cfg.cols
    per_col = torch.stack([torch.cat([
        tile_lsb(x[i:i + 1], out_slice(g[i:i + 1], c0, c1, transpose),
                 out_slice(ref[i:i + 1], c0, c1, transpose), sc[i:i + 1],
                 cfg, transpose).sum(0).repeat_interleave(width)[:c1 - c0]
        for c0, c1 in out_chunks(y_p.shape[-1], width,
                                 charges_per_col(x, g, cfg, transpose))])
        * sc[i, 1].abs() for i in range(x.shape[0])])
    bound = per_col[:, None, :] \
        + 1e-5 * torch.maximum(y_p.abs(), y_k.abs())
    thresh = 1e-5 * y_p.abs().amax()
    off = err > thresh
    share = off.float().mean().item()
    if share >= 0.01:
        before, tried, taken, moved = share, 0, 0, 0
        for i in range(x.shape[0]):
            tiles = off[i].any(dim=0)
            tiles = torch.nn.functional.pad(
                tiles, (0, (-tiles.shape[0]) % width)).reshape(-1, width)
            for tile in tiles.any(dim=1).nonzero()[:, 0].tolist():
                c0 = tile * width
                c1 = min(c0 + width, off.shape[-1])
                alt = tie_recount(y_k[i:i + 1], x[i:i + 1], g[i:i + 1],
                                  ref[i:i + 1], sc[i:i + 1], cfg, transpose,
                                  tile, thresh)
                tried += 1
                if alt is not None and alt.sum() < off[i, :, c0:c1].sum():
                    taken += 1
                    moved += alt.numel()
                    off[i, :, c0:c1] = alt
        share = off.float().mean().item()
        TIE_RECOUNTS.append({"x": list(x.shape), "tiles_tried": tried,
                             "tiles_recounted": taken,
                             "outputs_recounted": moved,
                             "share_before": before, "share_after": share})
    ok = bool((err <= bound).all()) and share < 0.01
    return ok, err.max().item(), (err / bound).max().item(), share


def dac_scale_ok(x, sc, in_levels):
    """Every lead matrix's DAC scale ``sc[:, 0]`` equals the float32
    division ``max(max|x|, 1e-12) / in_levels`` bit for bit (numpy's
    IEEE float32 division on the host).  On the card torch computes a
    division by a Python number as a product with its reciprocal, which
    can sit an ulp off and move a DAC code."""
    m = x.detach().abs().amax(dim=tuple(range(1, x.ndim))).cpu().numpy()
    want = np.maximum(m, np.float32(1e-12)) / np.float32(in_levels)
    return bool(np.array_equal(sc[:, 0].detach().cpu().numpy(), want))


#: Kernels that must issue tensor-core MMAs (HMMA in their SASS), by the
#: source they are built from.
TENSOR_CORE_KERNELS = {"xbar_vmm.cu": ("tc_range_kernel", "tc_read_kernel"),
                       "xbar_update.cu": ("tc_update_kernel",),
                       "xbar_fakequant.cu": ("fakequant_tc_kernel",),
                       "flash_attention.cu": ("flash_attention_kernel",)}


def tensor_core_check(nvcc, sources):
    """HMMA instructions per kernel function in ``cuobjdump -sass`` of the
    built libraries of ``sources``; fails if a tensor-core kernel has
    none."""
    counts = {}
    for source in sources:
        sass = subprocess.run(
            ["/usr/local/cuda/bin/cuobjdump", "-sass",
             str(nvcc.library_path(source))], capture_output=True,
            text=True, timeout=120).stdout
        func, first = None, {}
        for line in sass.splitlines():
            if "Function :" in line:
                func = line.split("Function :")[1].strip()
                counts[func] = 0
            elif "HMMA" in line and func is not None:
                counts[func] += 1
                first.setdefault(func, line.split(";")[0].split("*/")[-1]
                                 .strip())
        for name in TENSOR_CORE_KERNELS[source.name]:
            funcs = [f for f in counts if name in f]
            if not funcs or not all(counts[f] for f in funcs):
                fail(f"{name} in {source.name}: no HMMA in its SASS "
                     f"({ {f: counts[f] for f in funcs} })")
            print(f"{source.name} {name}: HMMA in all {len(funcs)} "
                  f"instances, e.g. {first[funcs[0]]}")
    return counts


def phase_kernel(K, cfg_of, report):
    """Kernel vs plain version at the slice's shapes; returns the rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    full = [(768, 2304), (768, 768), (768, 6144), (3072, 768)]
    cases = [(k, n, b, 64, True) for b in (4, 16, 2048) for k, n in full]
    cases += [(200, 72, 37, 64, False), (768, 2304, 16, 128, False),
              (768, 768, 384, 128, False), (768, 2304, 16, 256, False),
              (768, 2304, 16, 1024, False),
              # the tensor-core instance at the other tile sizes, and
              # 48-line tiles (padded lines, blocks across output tiles)
              (200, 72, 37, 48, False), (768, 2304, 64, 256, False),
              (768, 2304, 64, 1024, False)]
    rows = []
    for k, n, b, tile, timed in cases:
        for cls in ("pow2", "dynamic"):
            rows.append(kernel_case(K, cfg_of(tile, cls), k, n, b, tile, cls,
                                    timed and cls == "dynamic", gen, report))
    # a 12-bit DAC: codes not exact in bf16, so the FP32 instance at B > 16
    cfg = cfg_of(64, "dac12")
    if K.read_instance(64, cfg.adc.in_levels) != "fp32":
        fail("a 12-bit DAC read would take the tensor-core instance")
    rows.append(kernel_case(K, cfg, 768, 2304, 64, 64, "dac12", False, gen,
                            report))
    return rows


def kernel_case(K, cfg, k, n, b, tile, cls, timed, gen, report):
    """One forward read against its plain version: bit-equal in the pow2
    class, the one-lsb-per-tile bound otherwise."""
    x, g, ref, ws = make_operands(k, n, b, gen, cls == "pow2", "cuda")
    sc = K.read_scales(x, ws, cfg.adc.in_levels)
    if not dac_scale_ok(x, sc, cfg.adc.in_levels):
        fail(f"read_scales on the card is not the float32 division "
             f"max|x| / {cfg.adc.in_levels}: {sc[:, 0].tolist()}")
    y_k = K._read_cuda(x, g, ref, sc, cfg)
    torch.cuda.synchronize()
    y_p = K._read_plain(x, g, ref, sc, cfg)
    err = (y_k - y_p).abs()
    row = {"K": k, "N": n, "B": b, "tile": tile, "class": cls,
           "instance": K.read_instance(b, cfg.adc.in_levels),
           "max_abs_err": err.max().item()}
    if cls == "pow2":
        ok = torch.equal(y_k, y_p)
    else:
        ok, _, _, row["flip_share"] = read_agrees(y_k, y_p, x, g, ref, sc,
                                                  cfg)
    row["ok"] = ok
    if timed:
        row.update(time_read(K, x, g, ref, sc, cfg))
    report(row)
    if not ok:
        fail(f"kernel disagrees with its plain version: {row}")
    return row


def time_read(K, x, g, ref, sc, cfg, transpose=False):
    """Times of the kernel and the plain version, by torch.profiler and by
    CUDA events (back to back, host launch cost included), cycling over
    copies of the conductances so each launch finds them out of L2.  The
    bound is the FP32 one (the function's flops at 67 TFLOP/s, or its
    bytes).  Beside it, for the tensor-core instance: the function's
    tensor-core floor (one pass of the three bf16 parts at 989 TFLOP/s)
    and the design's own cost (twice that in dynamic range mode, whose
    range pass recomputes the products), which is not a bound."""
    b, d = x.shape[1:]
    k, n = g.shape[1:]
    pair = 2 * g.numel() * 4
    copies = max(2, min(64, math.ceil(3 * L2_BYTES / pair)))
    gs = [g.clone() for _ in range(copies)]
    rs = [ref.clone() for _ in range(copies)]
    sync = torch.cuda.synchronize
    flops = 2 * b * k * n
    iters = max(copies, 50 if flops < 1e10 else 5)

    def kern(i):
        return K._read_cuda(x, gs[i % copies], rs[i % copies], sc, cfg,
                            transpose)

    def plain(i):
        return K._read_plain(x, gs[i % copies], rs[i % copies], sc, cfg,
                             transpose)
    events_ms = cuda_ms(kern, iters, sync)
    events_plain_ms = cuda_ms(plain, iters, sync)
    ms, plain_ms = device_ms(kern, iters), device_ms(plain, iters)
    timing = "profiler"
    if ms is None or plain_ms is None:  # the profiler saw no kernel
        ms, plain_ms, timing = events_ms, events_plain_ms, "events"
    n_bytes = 4 * (b * d + 2 * k * n + 2 + b * (k + n - d))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    res = {"ms": ms, "plain_ms": plain_ms, "events_ms": events_ms,
           "events_plain_ms": events_plain_ms, "timing": timing,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_share": bound_ms / ms}
    if K.read_instance(b, cfg.adc.in_levels) == "tensor_core":
        passes = 2 if cfg.adc.range_mode != "fixed" else 1
        t_tc = 3 * flops / BF16_FLOPS
        res["tc_floor_ms"] = 1e3 * max(t_bytes, t_tc)
        res["tc_floor_share"] = res["tc_floor_ms"] / ms
        res["tc_design_ms"] = 1e3 * max(t_bytes, passes * t_tc)
    return res


def print_read_time(what, r):
    tc = (f", tensor-core floor {r['tc_floor_ms']:.4f} ms "
          f"({100 * r['tc_floor_share']:.1f}% of it; the design's two "
          f"passes {r['tc_design_ms']:.4f} ms)"
          if "tc_floor_ms" in r else "")
    print(f"  {what} K={r['K']} N={r['N']} B={r['B']} ({r['instance']}): "
          f"kernel {r['ms']:.4f} ms ({r['timing']}; events "
          f"{r['events_ms']:.4f}), plain {r['plain_ms']:.4f} ms (events "
          f"{r['events_plain_ms']:.4f}), FP32 bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}, {100 * r['bound_share']:.1f}% of bound){tc}, "
          f"max abs err {r['max_abs_err']:.3g}")


def phase_serve(M, K, make_engine, SamplingParams, acfg, dcfg,
                report):
    """lm100m at full width from programmed crossbars, continuous batching."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = M.init_params(dcfg.replace(dtype="float32"), gen, device="cuda")
    aparams = M.program_digital(params, acfg)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, acfg.vocab,
                                             rng.integers(8, 17))]
               for _ in range(4)]
    engine = make_engine(acfg, aparams, backend="analog", n_slots=4,
                         prefill_chunk=16, max_len=64)
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))  # warm-up
    torch.cuda.synchronize()
    sp = SamplingParams(max_new_tokens=32)
    stream = engine.stream
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, sp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = K.LAUNCHES["fused_vmm"]
    by_kernel = read_kernel_launches([K.LAUNCHES], "vmm")
    transposed = read_kernel_launches([K.LAUNCHES], "mvm")
    tiles, reduces = (by_kernel["fused_read_tile_kernel"],
                      by_kernel["reduce_tiles_kernel"])
    tc_reads, preps, ranges = (by_kernel["tc_read_kernel"],
                               by_kernel["read_prepare_kernel"],
                               by_kernel["tc_range_kernel"])
    m = stream.metrics
    calls = m["prefill_chunks"] + m["decode_steps"]
    n_tok = sum(len(o) for o in outs)
    res = {"tokens": n_tok, "seconds": dt, "tokens_per_s": n_tok / dt,
           "model_calls": calls, "prefill_chunks": m["prefill_chunks"],
           "decode_steps": m["decode_steps"], "launches": launches,
           "launches_by_kernel": by_kernel,
           "prompt_lens": [len(p) for p in prompts]}
    report(res)
    print(f"analog serving: {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tokens/s ({calls} model calls, {launches} "
          f"fused reads: {by_kernel})")
    per_call = 4 * acfg.n_layers      # wqkv, wo, w_upgate, w_down per layer
    # every lm100m read spans several 64-row K tiles, so an FP32 read also
    # launches the K-order sum, and a tensor-core read (dynamic range) its
    # pre-pass and range pass; serving makes no transpose read
    if launches != per_call * calls or tiles + tc_reads != launches \
            or reduces != tiles or preps != tc_reads or ranges != tc_reads \
            or any(transposed.values()) or calls == 0:
        fail(f"fused read launched {by_kernel} (transposed {transposed}) "
             f"for {launches} reads in {calls} model calls; expected "
             f"{per_call * calls} reads, each a tile launch with one sum or "
             f"a tensor-core read with one pre-pass and one range launch")
    if [len(o) for o in outs] != [32] * 4 or \
            not all(0 <= t < acfg.vocab for o in outs for t in o):
        fail(f"bad analog outputs {outs}")
    dengine = make_engine(dcfg, params, backend="digital", n_slots=1,
                          prefill_chunk=16, max_len=64)
    before = dict(K.LAUNCHES)
    dout = dengine.generate(prompts[:1], SamplingParams(max_new_tokens=8))
    if len(dout[0]) != 8 or K.LAUNCHES != before:
        fail(f"digital request: {dout}, launches moved from {before} to "
             f"{K.LAUNCHES}")
    print(f"digital request: {dout[0]}")
    return params, aparams, prompts, res


def run_steps(M, params, cfg, toks, next_toks):
    """Prefill logits of ``toks`` and the logits of one decode step per
    entry of ``next_toks``; greedy tokens from the card when
    ``next_toks`` is None."""
    dev = M.params_device(params)
    with torch.no_grad():
        logits, cache = M.prefill(params, {"tokens": toks.to(dev)}, cfg, 32)
        out, fed = [logits.cpu()], []
        for i in range(4):
            tok = logits.argmax(-1) if next_toks is None \
                else next_toks[i].to(dev)
            fed.append(tok.cpu())
            logits, cache = M.decode_step(params, cache, tok, cfg)
            out.append(logits.cpu())
    return out, fed


def max_diff(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def check_reads(K, reads, where="cpu"):
    """Every read the card ran, held against the plain version fed the
    same operands, on the CPU (``where="cpu"``) or on the card: within one
    ADC lsb per reduction tile per element, and under 1% of the elements
    more than 1e-5 relative off (phase 1's bound).  A read that skipped
    the ADC or returned a float product would be off by up to half an lsb
    per tile on nearly every element.  Every read's DAC scale must also
    be the float32 division ``max|x| / in_levels`` bit for bit
    (:func:`dac_scale_ok`)."""
    moved = {}

    def to(t):
        key = (t.data_ptr(), tuple(t.shape))
        if key not in moved:
            moved[key] = t.to(where)
        return moved[key]

    worst = {"max_abs_err": 0.0, "max_err_over_bound": 0.0,
             "max_flip_share": 0.0, "zero_leads": 0}
    for x, g, ref, sc, cfg, y, transpose in reads:
        if not dac_scale_ok(x, sc, cfg.adc.in_levels):
            fail(f"a read's DAC scale {sc[:, 0].tolist()} is not the "
                 f"float32 division max|x| / {cfg.adc.in_levels} (x "
                 f"{tuple(x.shape)}, transpose {transpose})")
        x, g, ref, sc = x.to(where), to(g), to(ref), sc.to(where)
        y = y.to(where)
        for i in range(x.shape[0]):   # a lead matrix (expert) at a time
            one = (x[i:i + 1], g[i:i + 1], ref[i:i + 1], sc[i:i + 1])
            y_p = plain_read(K, *one, cfg, transpose)
            ok, err, over, share = read_agrees(y[i:i + 1], y_p, *one, cfg,
                                               transpose)
            if not x[i].any():        # an expert that received no token
                worst["zero_leads"] += 1
                ok = ok and not y[i].any() and not y_p.any()
            worst["max_abs_err"] = max(worst["max_abs_err"], err)
            worst["max_err_over_bound"] = max(worst["max_err_over_bound"],
                                              over)
            worst["max_flip_share"] = max(worst["max_flip_share"], share)
            if not ok:
                fail(f"a read disagrees with the plain version on its "
                     f"operands: x {tuple(x.shape)} g {tuple(g.shape)} "
                     f"lead matrix {i}, transpose {transpose}, max err "
                     f"{err}, err/bound {over}, flip share {share}")
    return worst


def phase_card_vs_cpu(M, K, acfg, params, aparams, report):
    """The same weights and tokens on the card (kernel) and the CPU (plain
    version): prefill of a (4, 12) batch and 4 greedy decode steps.

    Gates: (a) every read of the card's run against the plain version on
    the card's own read operands (``check_reads``); (b) the card's logits
    against the CPU's when the CPU's reads return the card's read results:
    then only the digital ops (attention, norms, embedding, logits) differ,
    by float32 rounding, so the bound is 1e-3; (c) the free-running CPU,
    whose 8-bit ADC codes flip at rounding boundaries and cascade through
    the layers: a gross check only, bound twice the analog read's own
    error (analog vs float32 digital logits), which (a) and (b) make
    tight."""
    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.cpu()
    cpu_params = to_cpu(aparams)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, acfg.vocab, (4, 12)))

    reads, read_plain = [], K._read_plain
    with recording_reads(K, reads):
        card, fed = run_steps(M, aparams, acfg, toks, None)
    dig, _ = run_steps(M, params, acfg.digital(), toks, fed)
    cpu, _ = run_steps(M, cpu_params, acfg, toks, fed)
    replay = iter(reads)

    def replayed(x, g, ref, sc, cfg, transpose=False):
        y = next(replay)[5]
        if y.shape != (x.shape[0], x.shape[1], g.shape[2]):
            fail(f"replayed read of shape {tuple(y.shape)} for x "
                 f"{tuple(x.shape)} g {tuple(g.shape)}")
        return y.cpu()

    K._read_plain = replayed
    try:
        forced, _ = run_steps(M, cpu_params, acfg, toks, fed)
    finally:
        K._read_plain = read_plain
    if next(replay, None) is not None:
        fail("the CPU run made fewer reads than the card's")
    worst = check_reads(K, reads)
    gap = max_diff(card, dig)
    res = {"reads_checked": len(reads), **worst,
           "forced_max_abs_logit_diff": max_diff(card, forced),
           "forced_bound": 1e-3,
           "max_abs_logit": max(t.abs().max().item() for t in card),
           "max_abs_logit_diff": max_diff(card, cpu),
           "per_step": [(a - b).abs().max().item()
                        for a, b in zip(card, cpu)],
           "analog_vs_digital": gap, "bound": 2 * gap,
           "greedy_agree": [torch.equal(a.argmax(-1), b.argmax(-1))
                            for a, b in zip(card, cpu)]}
    report(res)
    print(f"card vs CPU: {len(reads)} reads of the run agree with the plain "
          f"version on their operands (max abs err {worst['max_abs_err']:.3g}"
          f", {worst['max_err_over_bound']:.3f} of the one-lsb-per-tile "
          f"bound, flip share at most {worst['max_flip_share']:.2g}); logits "
          f"with the card's reads replayed on the CPU differ by "
          f"{res['forced_max_abs_logit_diff']:.3g} (bound 1e-3, logits up to "
          f"{res['max_abs_logit']:.3g}); free-running CPU max abs logit "
          f"difference {res['max_abs_logit_diff']:.6f} (gross bound "
          f"{2 * gap:.6f} = 2 x analog-vs-digital error); greedy tokens "
          f"agree per step {res['greedy_agree']}")
    if not res["forced_max_abs_logit_diff"] <= 1e-3:
        fail(f"card and CPU logits differ with the reads replayed: {res}")
    if not res["max_abs_logit_diff"] <= 2 * gap:
        fail(f"card and CPU logits differ beyond the bound: {res}")
    return res


def phase_profile(M, acfg, aparams, report):
    """Device time of 4 decode steps (B=4) by kernel, from torch.profiler,
    against the wall time of 4 unprofiled steps just before; reported
    only, it gates nothing."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, acfg.vocab, (4, 12))).cuda()
    with torch.no_grad():
        logits, cache = M.prefill(aparams, {"tokens": toks}, acfg, 32)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            logits, cache = M.decode_step(aparams, cache, tok, acfg)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                logits, cache = M.decode_step(aparams, cache, tok, acfg)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0

    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU]
    total = kernel_us(prof)
    read = sum(dev_us(e) for e in events
               if any(name in e.key for name in READ_KERNELS))
    top = sorted(events, key=dev_us, reverse=True)[:8]
    res = {"wall_ms_per_step": 1e3 * wall / 4,
           "profiled_wall_ms_per_step": 1e3 * prof_wall / 4,
           "device_ms_per_step": total / 4e3,
           "read_ms_per_step": read / 4e3,
           "idle_share": (1 - total / 1e6 / wall) if total else None,
           "top": [(e.key[:60], dev_us(e) / 4e3, e.count // 4) for e in top]}
    report(res)
    if total:
        prof_ms = res["profiled_wall_ms_per_step"]
        print(f"profile (4 decode steps, B=4): {res['wall_ms_per_step']:.3f} "
              f"ms/step wall unprofiled ({prof_ms:.3f} under the "
              f"profiler), {res['device_ms_per_step']:.3f} "
              f"ms/step device ({res['read_ms_per_step']:.3f} in the fused "
              f"read), device idle {100 * res['idle_share']:.1f}% of the "
              f"unprofiled wall")
    else:
        print("profile: the profiler recorded no device time (not measured)")


def phase_default_tiles(M, K, acfg, params, report):
    """One prefill and one decode step from crossbars at the config's
    default 1024x1024 tiles (the paper's array size): every read against
    the plain version on its own operands (phase 1's bound)."""
    cfg = acfg.replace(analog_rows=1024, analog_cols=1024)
    aparams = M.program_digital(params, cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 12))).cuda()
    reads = []
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    with recording_reads(K, reads), torch.no_grad():
        logits, cache = M.prefill(aparams, {"tokens": toks}, cfg, 32)
        logits, cache = M.decode_step(aparams, cache, logits.argmax(-1), cfg)
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    if launches["fused_vmm"] != 2 * 4 * cfg.n_layers \
            or not torch.isfinite(logits).all():
        fail(f"1024x1024 tiles: {launches} launches, finite logits "
             f"{bool(torch.isfinite(logits).all())}")
    worst = check_reads(K, reads)
    res = {"tile": 1024, "reads_checked": len(reads), "launches": launches,
           **worst}
    report(res)
    print(f"1024x1024 tiles: prefill + 1 decode step, {len(reads)} reads "
          f"({launches}) within the plain version's bound (max abs err "
          f"{worst['max_abs_err']:.3g}, flip share at most "
          f"{worst['max_flip_share']:.2g})")
    return res


#: The read's kernels, as the profiler names them, and their launch counts
#: in ``kernels.xbar_vmm.LAUNCHES`` (one per direction: ``{count}_vmm``,
#: ``{count}_mvm``).
READ_KERNEL_COUNTS = {"fused_read_tile_kernel": "read_tile",
                      "reduce_tiles_kernel": "reduce_tiles",
                      "read_prepare_kernel": "read_prepare",
                      "tc_range_kernel": "read_range",
                      "tc_read_kernel": "tc_read"}
READ_KERNELS = tuple(READ_KERNEL_COUNTS)


def read_kernel_launches(steps, direction):
    """Launches of each of the read's kernels in one direction (``vmm`` or
    ``mvm``), summed over ``steps`` (dicts of the wrappers' counts)."""
    return {kernel: sum(step[f"{count}_{direction}"] for step in steps)
            for kernel, count in READ_KERNEL_COUNTS.items()}


def tensor_core_train_expect(n_layers, **others):
    """A training step's expected launch counts: 4 forward and 4 transpose
    reads per layer, each on the tensor-core instance with its pre-pass and
    range pass, nothing on the FP32 instance; ``others`` the rest."""
    reads = 4 * n_layers
    expect = {"fused_vmm": reads, "fused_mvm": reads, "fakequant_split": 0,
              "fakequant_tiles": 0, "fakequant_lead": 0, **others}
    for d in ("vmm", "mvm"):
        for count in READ_KERNEL_COUNTS.values():
            expect[f"{count}_{d}"] = 0 if count in ("read_tile",
                                                   "reduce_tiles") else reads
    return expect
TRAIN_SHAPES = [("wqkv", 768, 2304), ("wo", 768, 768),
                ("w_upgate", 768, 6144), ("w_down", 3072, 768)]


def phase_mvm(K, cfg_of, report):
    """The transpose read against its plain version on the card: the four
    containers at training (B = T = 2048) and prefill-chunk (B = 16) batch
    sizes, a ragged case and 128x128 / 1024x1024 tiles (FP32 instance),
    and, on the tensor-core instance, 48x48 tiles and 128/256/1024 tiles at
    B = 64; pow2 class bit-equal, dynamic class within one lsb per N
    tile."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases = [(k, n, b, 64, b == 2048) for b in (2048, 16)
             for _, k, n in TRAIN_SHAPES]
    cases += [(200, 72, 37, 64, False), (768, 2304, 16, 128, False),
              (768, 2304, 16, 1024, False), (200, 72, 37, 48, False),
              (768, 2304, 64, 128, False), (768, 2304, 64, 256, False),
              (768, 2304, 64, 1024, False)]
    rows = []
    for k, n, b, tile, timed in cases:
        for cls in ("pow2", "dynamic"):
            cfg = cfg_of(tile, cls)
            _, g, ref, ws = make_operands(k, n, 1, gen, cls == "pow2", dev)
            d = torch.randn((1, b, n), generator=gen, device=dev)
            sc = K.read_scales(d, ws, cfg.adc.in_levels)
            y_k = K._read_cuda(d, g, ref, sc, cfg, True)
            torch.cuda.synchronize()
            y_p = K._read_plain(d, g, ref, sc, cfg, True)
            row = {"K": k, "N": n, "B": b, "tile": tile, "class": cls,
                   "instance": K.read_instance(b, cfg.adc.in_levels),
                   "max_abs_err": (y_k - y_p).abs().max().item()}
            if cls == "pow2":
                ok = torch.equal(y_k, y_p)
            else:
                ok, _, _, row["flip_share"] = read_agrees(
                    y_k, y_p, d, g, ref, sc, cfg, True)
            row["ok"] = ok
            if timed and cls == "dynamic":
                row.update(time_read(K, d, g, ref, sc, cfg, True))
            rows.append(row)
            report(row)
            if not ok:
                fail(f"transpose read disagrees with its plain version: "
                     f"{row}")
    for r in rows:
        if "ms" in r:
            print_read_time("MVM", r)
    print(f"phase 5: {len(rows)} transpose-read cases agree")
    return rows


def update_bound(g_p, g_old):
    """Kernel vs plain version of a noisy write: 4 float32 ulp of the new
    conductance (in [0, 1]) plus 1e-5 of the cell's move.  The
    accumulate's float32 sums are taken in another order; the epilogue's
    operations are the same, with another libm's exp/log/cos/sin.  A
    wrong hash moves a cell by a write-noise sigma, orders of magnitude
    more."""
    return 4 * 2.0 ** -24 + 1e-5 * (g_p - g_old).abs()


def update_operands(lyr, k, n, t, gen, pow2):
    """Operands of a write as the write drivers form them: integer codes
    (8-bit rows, 4-bit columns) times one scale per layer.  Returns (g,
    x_q, d_q, scale, x_scale, d_scale)."""
    dev = gen.device
    xi = torch.randint(-127, 128, (lyr, t, k), generator=gen, device=dev)
    di = torch.randint(-7, 8, (lyr, t, n), generator=gen, device=dev)
    if pow2:   # max|x| = 127 * 2^-7, max|d| = 7 * 2^-14: exact sums
        xs = torch.full((lyr,), 2.0 ** -7, device=dev)
        ds = torch.full((lyr,), 2.0 ** -14, device=dev)
        scale = torch.full((lyr,), -2.0 ** -4, device=dev)
    else:      # lm100m's training regime: lr 0.1, w_scale about 1.7
        xs = torch.full((lyr,), 3.0 / 127, device=dev)
        ds = torch.full((lyr,), 2e-4 / 7, device=dev)
        scale = -0.1 * (1.5 + 0.5 * torch.rand((lyr,), generator=gen,
                                               device=dev))
    g = 0.5 + 0.1 * torch.randn((lyr, k, n), generator=gen, device=dev)
    return (g.clamp(0, 1), xi.float() * xs[:, None, None],
            di.float() * ds[:, None, None], scale, xs, ds)


#: Under this share of the cells, a tensor-core write may use the
#: sum-rounding allowance of ``tc_write_agrees`` (as ``pulse_agrees``
#: allows count flips at ties).
SUM_TIE_SHARE = 1e-3


def tc_write_agrees(g_k, g_p, g_x, g, x_q, d_q, scale, cfg, z):
    """The float class of a tensor-core write ``g_k`` on codes times scales.

    Against ``g_x``, the plain twin of its own arithmetic
    (``_update_tc_plain``: the same exact integer sums, ``fl(sum) *
    fl(x_scale d_scale)`` and the same epilogue): ``update_bound`` on
    every cell.  Against ``g_p``, the plain version (the reference's
    float32 sum of ``x_q d_q``): pulse-train, ``pulse_agrees``; outer,
    ``update_bound`` on every cell but the sum-rounding ties, cells where
    the two plain versions already differ by more than ``update_bound``
    (a float32 sum that cancels to its own rounding residual where the
    exact sum is zero, magnified by sigma ~ sqrt|dg_req|); the caller
    holds that share under ``SUM_TIE_SHARE`` (pooled over a layer checked
    in column slices).  ``z`` is the write's normal field.  Returns (ok,
    max abs err vs g_p, largest err / bound vs g_x, share of cells that
    used an allowance)."""
    err_x = (g_k - g_x).abs()
    over_x = (err_x / update_bound(g_x, g)).max().item()
    if cfg.update_mode == "pulse_train":
        ok, err, _, share = pulse_agrees(g_k, g_p, g, x_q, d_q, scale, cfg,
                                         z)
    else:
        bound = update_bound(g_p, g)
        tie = (g_x - g_p).abs() > bound
        share = tie.float().mean().item()
        err_p = (g_k - g_p).abs()
        ok = bool(((err_p <= bound) | tie).all())
        err = err_p.max().item()
    return ok and over_x <= 1.0, err, over_x, share


def codes_contract_ok(U, x_q, d_q, xs, ds, cfg):
    """Whether the operands really are codes times their scales: the
    pre-pass's plain twin, scaled back, gives x_q and d_q bit for bit."""
    t_tok, k = x_q.shape[1:]
    px, pd = U._update_codes_plain(x_q, d_q, xs, ds, cfg)
    return (torch.equal(px[:, :t_tok, :k].float() * xs[:, None, None], x_q)
            and torch.equal(pd[:, :t_tok, :d_q.shape[2]].float()
                            * ds[:, None, None], d_q))


def write_bounds(U, lyr, t, k, n, pulse, host):
    """Times (ms) that bound one write: the function's floor (its tapes
    read once, G in and out, and host noise, at the HBM rate; its products
    at the bf16 tensor-core rate) and what bounds it, its bound on the
    FP32 cores, the tensor-core design's own (plus the bf16 code planes
    written and read once) and the pre-pass's (bytes)."""
    flops = (4 if pulse else 2) * lyr * t * k * n
    n_bytes = 4 * (lyr * t * (k + n) + 3 * lyr
                   + lyr * k * n * (3 if host else 2))
    tp, kp, np_ = U.update_code_dims(t, k, n)
    planes = 2 * lyr * tp * (kp + np_)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_tc, t_fp = flops / BF16_FLOPS, flops / FP32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_tc),
            "bound_by": "bytes" if t_bytes >= t_tc else "operations",
            "bytes_ms": 1e3 * t_bytes, "tc_operations_ms": 1e3 * t_tc,
            "fp32_bound_ms": 1e3 * max(t_bytes, t_fp),
            "design_ms": 1e3 * max(t_bytes + 2 * planes / HBM_BYTES_PER_S,
                                   t_tc),
            "prepass_bound_ms": 1e3 * (4 * lyr * t * (k + n) + 8 * lyr
                                       + planes) / HBM_BYTES_PER_S}


def write_case(U, g, x_q, d_q, scale, xs, ds, noise, seed, mode, cfg,
               exact, fp32, timed):
    """One write against its plain versions on the card.  With the scales
    ``xs``/``ds`` (codes times scales): the tensor-core instance, its
    pre-pass bit-equal to the plain twin, the write bit-equal to the plain
    version in the ``exact`` class, else ``tc_write_agrees``.  With
    ``fp32`` (or no scales), the FP32 instance on the float operands:
    bit-equal if ``exact``, else ``update_bound`` (outer) or
    ``pulse_agrees`` (pulse-train).  ``timed``: CUDA-event times of each
    instance, the pre-pass, the plain version and torch.bmm of the
    accumulate(s) alone (not the same function), beside the bounds.
    Returns the report row; fails on a disagreement."""
    sync = torch.cuda.synchronize
    pulse = cfg.update_mode == "pulse_train"
    lyr, k, n = g.shape
    t = x_q.shape[1]
    g_p = U._update_plain(g, x_q, d_q, scale, noise, seed, cfg, mode)
    z = None
    if not exact:
        z = noise if mode == "host" else U.field_normals(seed, g.shape, cfg,
                                                         device="cuda")
    row = {"max_move": (g_p - g).abs().max().item()}

    def kern(i, scaled=True):
        return U.xbar_outer_update(g, x_q, d_q, scale, cfg, noise=noise,
                                   seed=seed, noise_mode=mode,
                                   x_scale=xs if scaled else None,
                                   d_scale=ds if scaled else None)
    if xs is not None:
        if not codes_contract_ok(U, x_q, d_q, xs, ds, cfg):
            fail("write operands are not codes times their scales")
        before = dict(U.LAUNCHES)
        g_k = kern(0)
        codes = U._update_prepare_cuda(x_q, d_q, xs, ds, cfg)
        sync()
        if (U.LAUNCHES["update_tc"] - before["update_tc"],
                U.LAUNCHES["update_fp32"] - before["update_fp32"]) != (1, 0):
            fail(f"a scaled write did not take the tensor-core instance: "
                 f"{U.LAUNCHES}")
        px, pd = U._update_codes_plain(x_q, d_q, xs, ds, cfg)
        cx, cd = U.code_planes(codes, lyr, t, k, n)
        row["prepass_ok"] = torch.equal(cx, px) and torch.equal(cd, pd)
        del codes, cx, cd, px, pd
        row["max_abs_err"] = (g_k - g_p).abs().max().item()
        if exact:
            ok = torch.equal(g_k, g_p)
        else:
            g_x = U._update_tc_plain(g, x_q, d_q, scale, noise, seed, cfg,
                                     mode, xs, ds)
            ok, _, row["max_err_over_twin_bound"], row["allowance_share"] = \
                tc_write_agrees(g_k, g_p, g_x, g, x_q, d_q, scale, cfg, z)
            ok = ok and row["allowance_share"] < SUM_TIE_SHARE
            del g_x
        row["ok"] = ok and row["prepass_ok"]
        del g_k
        if not row["ok"]:
            fail(f"tensor-core write disagrees with its plain versions: "
                 f"{row}")
    if fp32 or xs is None:
        g_f = kern(0, scaled=False)
        sync()
        row["fp32_max_abs_err"] = (g_f - g_p).abs().max().item()
        if exact:
            ok = torch.equal(g_f, g_p)
        elif pulse:
            ok, _, _, row["fp32_tie_share"] = pulse_agrees(
                g_f, g_p, g, x_q, d_q, scale, cfg, z)
        else:
            ok = bool(((g_f - g_p).abs() <= update_bound(g_p, g)).all())
        row["fp32_ok"] = ok
        del g_f
        if not ok:
            fail(f"FP32 write disagrees with its plain version: {row}")
    if timed:
        row["ms"] = cuda_ms(kern, 5, sync)
        row["prepass_ms"] = cuda_ms(
            lambda i: U._update_prepare_cuda(x_q, d_q, xs, ds, cfg), 5, sync)
        row["prepass_plain_ms"] = cuda_ms(
            lambda i: U._update_codes_plain(x_q, d_q, xs, ds, cfg), 3, sync)
        row["fp32_ms"] = cuda_ms(lambda i: kern(i, scaled=False), 3, sync)
        row["plain_ms"] = cuda_ms(
            lambda i: U._update_plain(g, x_q, d_q, scale, noise, seed, cfg,
                                      mode), 3, sync)
        row.update(write_bounds(U, lyr, t, k, n, pulse, noise is not None))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["fp32_bound_share"] = row["fp32_bound_ms"] / row["fp32_ms"]
        xt = x_q.transpose(1, 2).contiguous()
        if pulse:
            xa, da = xt.abs(), d_q.abs()
            row["accumulates_bmm_ms_not_the_same_function"] = cuda_ms(
                lambda i: (torch.bmm(xt, d_q), torch.bmm(xa, da)), 5, sync)
        else:
            row["accumulate_bmm_ms_not_the_same_function"] = cuda_ms(
                lambda i: torch.bmm(xt, d_q), 5, sync)
        del xt
    return row


def print_write(what, row):
    bmm = row.get("accumulate_bmm_ms_not_the_same_function",
                  row.get("accumulates_bmm_ms_not_the_same_function"))
    print(f"  {what} (L {row['L']}, K {row['K']}, N {row['N']}) T="
          f"{row['T']}: tensor cores {row['ms']:.3f} ms (pre-pass "
          f"{row['prepass_ms']:.3f}), {100 * row['bound_share']:.1f}% of the "
          f"floor {row['bound_ms']:.3f} ms ({row['bound_by']}; the design's "
          f"own {row['design_ms']:.3f}); FP32 instance {row['fp32_ms']:.3f} "
          f"ms, {100 * row['fp32_bound_share']:.1f}% of its bound "
          f"{row['fp32_bound_ms']:.3f}; plain {row['plain_ms']:.3f} ms; "
          f"torch.bmm of the accumulate(s) alone (not the same function) "
          f"{bmm:.3f} ms; max abs err {row['max_abs_err']:.3g} (cells moved "
          f"up to {row['max_move']:.3g}), allowance share "
          f"{row.get('allowance_share', 0.0):.2g}")


def phase_update(U, TAOX, CrossbarConfig, xcfg_of, report):
    """The rank-k write against its plain versions on the card, at each
    container's (12, K, N) with T = 2048, through the tensor-core instance
    (codes and scales from ``update_operands``): (a) ideal device, no
    noise, power-of-two scales, bit-equal; (b) TaOx, counter-PRNG noise
    and (c) TaOx, host noise field, ``tc_write_agrees``.  The FP32
    instance runs the (b) cases too (``update_bound``), the ragged cases
    and 1024x1024 tiles; both instances are timed on (b)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = []
    cases = [(name, 12, k, n, 2048, case, (64, 64), xcfg_of(case).device)
             for name, k, n in TRAIN_SHAPES
             for case in ("ideal", "kernel", "host")]
    # the epilogue's general TaOx branch (separate SET/RESET factors, a
    # linear SET side) and odd tile widths (one Box-Muller draw per cell)
    cases += [("asym", 2, 200, 72, 37, "kernel", (48, 63),
               TAOX.replace(nu_set=3.0, nu_reset=6.0, gain_set=1.2,
                            gain_reset=0.8)),
              ("linear_set", 2, 200, 72, 37, "kernel", (64, 15),
               TAOX.replace(nu_set=0.0)),
              ("tile1024", 12, 768, 2304, 2048, "kernel", (1024, 1024),
               TAOX)]
    for name, lyr, k, n, t, case, tile, dev in cases:
        cfg = CrossbarConfig(rows=tile[0], cols=tile[1], device=dev)
        g, x_q, d_q, scale, xs, ds = update_operands(lyr, k, n, t, gen,
                                                     case == "ideal")
        noise = torch.randn(g.shape, generator=gen, device="cuda") \
            if case == "host" else None
        seed = 0x9E3779B9 if case == "kernel" else None
        mode = {"ideal": "none"}.get(case, case)
        row = {"container": name, "L": lyr, "K": k, "N": n, "T": t,
               "tile": list(tile), "case": case}
        row.update(write_case(
            U, g, x_q, d_q, scale, xs, ds, noise, seed, mode, cfg,
            exact=case == "ideal", fp32=case == "kernel",
            timed=case == "kernel" and tile == (64, 64)))
        rows.append(row)
        report(row)
        if "ms" in row:
            print_write(f"update {name}", row)
        del g, x_q, d_q, noise
    print(f"phase 6: {len(rows)} update cases agree (tensor-core instance "
          f"in all, FP32 instance in {sum('fp32_ok' in r for r in rows)})")
    return rows


def tree_to(t, dev):
    if isinstance(t, dict):
        return {k: tree_to(v, dev) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(tree_to(v, dev) for v in t)
    if isinstance(t, float):
        return t
    return t.to(dev)


def tree_leaves(t, path=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from tree_leaves(v, path + (k,))
    else:
        yield path, t


def write_call(update_cuda, args, kw):
    """A call of ``U._update_cuda`` as its full argument tuple, defaults
    filled: (g, x_q, d_q, scale, noise, seed, cfg, mode, x_scale, d_scale,
    offs)."""
    bound = inspect.signature(update_cuda).bind(*args, **kw)
    bound.apply_defaults()
    return tuple(bound.arguments.values())


def recording_writes(U, writes):
    """A stand-in for ``U._update_cuda`` that records every write with its
    operands (scales and tile offsets included) and result."""
    update_cuda = U._update_cuda

    def rec_write(*args, **kw):
        out = update_cuda(*args, **kw)
        g, x_q, d_q, scale, noise, seed, cfg, mode, xs, ds, offs = \
            write_call(update_cuda, args, kw)
        writes.append(((g, x_q.clone(), d_q.clone(), scale.clone(), noise,
                        seed, cfg, mode,
                        None if xs is None else xs.clone(),
                        None if ds is None else ds.clone(), offs),
                       out.clone()))
        return out
    return rec_write


#: Cells of one layer a write check forms at once: a larger outer write
#: (the VLM's ``w_upgate``, 8192 x 57344, beside 60 GB held) is checked
#: in slices of whole column tiles, each with its slice of the noise
#: field, the allowance shares pooled over the layer.
WRITE_CHECK_CELLS = 2 ** 28


def check_writes(U, writes, what, worst=None):
    """Every recorded write of a training step against its plain versions
    on its own operands, one flattened layer at a time (a stack of 16
    full-width experts does not fit the plain versions' temporaries at
    once; an outer write's layer over ``WRITE_CHECK_CELLS`` goes in column
    slices), each layer with its own noise field: the operands are codes
    times the scales they came with, and each layer is in
    ``tc_write_agrees``'s class.  Returns the worst figures, gathered into
    ``worst`` where one is given."""
    if worst is None:
        worst = {"max_abs_err": 0.0, "max_err_over_twin_bound": 0.0,
                 "max_allowance_share": 0.0}
    for (g, x_q, d_q, scale, noise, seed, cfg, mode, xs, ds, offs), out \
            in writes:
        if xs is None or not codes_contract_ok(U, x_q, d_q, xs, ds, cfg):
            fail(f"a write of {what} came without scales that make its "
                 f"operands codes times scales: g {tuple(g.shape)}")
        k, n = g.shape[1:]
        step = n if k * n <= WRITE_CHECK_CELLS \
            or cfg.update_mode == "pulse_train" \
            else max(cfg.cols, WRITE_CHECK_CELLS // k // cfg.cols * cfg.cols)
        for i in range(g.shape[0]):
            ok, err, over, ties = True, 0.0, 0.0, 0.0
            for c0 in range(0, n, step):
                c1 = min(c0 + step, n)
                z = U.field_normals(seed, (1, k, c1 - c0), cfg,
                                    (offs[0] + i, offs[1],
                                     offs[2] + c0 // cfg.cols),
                                    device=g.device) if mode == "kernel" \
                    else (None if noise is None
                          else noise[i:i + 1, :, c0:c1])
                one = (g[i:i + 1, :, c0:c1], x_q[i:i + 1],
                       d_q[i:i + 1, :, c0:c1], scale[i:i + 1])
                m = "none" if z is None else "host"
                g_p = U._update_plain(*one, z, None, cfg, m)
                g_x = U._update_tc_plain(*one, z, None, cfg, m, xs[i:i + 1],
                                         ds[i:i + 1])
                ok_c, err_c, over_c, share_c = tc_write_agrees(
                    out[i:i + 1, :, c0:c1], g_p, g_x, *one, cfg, z)
                del g_p, g_x, z
                ok, err, over = ok and ok_c, max(err, err_c), max(over,
                                                                  over_c)
                ties += share_c * (c1 - c0)
            share = ties / n
            ok = ok and share < SUM_TIE_SHARE
            worst["max_abs_err"] = max(worst["max_abs_err"], err)
            worst["max_err_over_twin_bound"] = max(
                worst["max_err_over_twin_bound"], over)
            worst["max_allowance_share"] = max(
                worst["max_allowance_share"], share)
            if not ok:
                fail(f"a write of {what} disagrees with its plain versions "
                     f"at layer {i}: g {tuple(g.shape)}, max err {err}, "
                     f"{over} of the twin's bound, allowance share {share}")
    return worst


def check_step1(K, U, reads, writes):
    """Every launch of train step 1 against its plain version on the card,
    on that launch's own operands: reads with phase 1's bound, writes with
    ``check_writes``.  Returns (worst read stats, worst write stats)."""
    return check_reads(K, reads, where="cuda"), check_writes(
        U, writes, "train step 1")


def phase_train(K, U, TA, M, syn, tcfg, report):
    """lm100m at full width trained in device mode: ``init_state`` from
    torch.Generator seed 0, 4 steps of ``make_analog_sgd_step`` (lr 0.1,
    TaOx, counter-PRNG write noise) on batches of 8 x 256 tokens.

    Gates: each step launches 48 forward reads, 48 transpose reads (each
    on the tensor-core instance: a pre-pass and a range launch beside it,
    no tile-order sum) and 4 writes, each on the tensor-core instance with
    its pre-pass, none on the FP32 instance; every launch of step 1 agrees
    with its plain version on the card on its own operands (phases 1, 5
    and 6's bounds; the writes' operands are codes times the scales they
    come with); the digital leaves after step 1 agree with a CPU run
    of the step that replays the card's read and write results, within
    1e-3 of each leaf's own move plus 1e-6 (float32 rounding of attention,
    norms, embedding, logits and their gradients remains); the loss is
    finite and the conductances stay in the window."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = TA.init_state(gen, tcfg, device="cuda")
    step = TA.make_analog_sgd_step(tcfg, lr=0.1)
    stream = syn.make_token_stream(200_000, tcfg.vocab, seed=0)
    rng = torch.Generator(device="cuda")
    rng.manual_seed(1)
    state0_cpu = tree_to(state, "cpu")
    n_layers = tcfg.n_layers
    expect = tensor_core_train_expect(
        n_layers, fakequant=0, **dict.fromkeys(FQ_KERNELS.values(), 0),
        outer_update=4,
        pulse_update=0, update_tc=4, update_prepare=4, update_fp32=0)
    reads, writes = [], []
    update_cuda = U._update_cuda
    rec_write = recording_writes(U, writes)

    losses, rails, step_ms, launches, seeds = [], [], [], [], []
    for i in range(4):
        x, y = syn.batch_tokens(stream, 8, 256, i)
        batch = {"tokens": torch.from_numpy(x).long().cuda(),
                 "labels": torch.from_numpy(y).long().cuda()}
        seed_base = int(torch.randint(0, 2 ** 32, (), generator=rng,
                                      device="cuda"))
        seeds.append(seed_base)
        reset_launches(K, U)
        # only step 1 records its launches; steps 2-4, which give the
        # step time, tokens/s and peak memory, run the kernels bare
        record = recording_reads(K, reads) if i == 0 \
            else contextlib.nullcontext()
        U._update_cuda = rec_write if i == 0 else update_cuda
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with record:
                state, mets = step(state, batch, seed_base)
                torch.cuda.synchronize()
        finally:
            U._update_cuda = update_cuda
        step_ms.append(1e3 * (time.perf_counter() - t0))
        got = {**K.LAUNCHES, **U.LAUNCHES}
        launches.append(got)
        losses.append(float(mets["loss"]))
        rails.append(float(mets["g_rail_frac"]))
        print(f"  train step {i + 1}: loss {losses[-1]:.5f}, g_rail_frac "
              f"{rails[-1]:.3g}, {step_ms[-1]:.1f} ms, launches {got}")
        if got != expect:
            fail(f"train step {i + 1} launched {got}; expected {expect}")
        if not math.isfinite(losses[-1]):
            fail(f"train step {i + 1}: loss {losses[-1]}")
        if i == 0:
            params1 = tree_to(state["params"], "cpu")
            checked = check_step1(K, U, reads, writes)
            # keep only the results the CPU replay needs, off the card
            replay_reads = [r[5].cpu() for r in reads]
            replay_writes = [w[1].cpu() for w in writes]
            n_reads, n_writes = len(reads), len(writes)
            reads.clear()
            writes.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_train_step(K, U, syn, step, state, stream, rng,
                                 expect)
    for path, g in tree_leaves(state["params"]):
        if path[-1] == "g" and not (g.min() >= 0 and g.max() <= 1):
            fail(f"conductances of {path} left the window")
    worst, upd = checked

    # the digital leaves: a CPU run of step 1 replaying the card's reads
    # and writes
    replay_r = iter(replay_reads)
    replay_w = iter(replay_writes)
    read_plain, update_plain = K._read_plain, U._update_plain

    def rep_read(x, g, ref, sc, cfg, transpose=False):
        return next(replay_r).cpu()

    def rep_write(g, *args):
        return next(replay_w).cpu()

    x, y = syn.batch_tokens(stream, 8, 256, 0)
    K._read_plain, U._update_plain = rep_read, rep_write
    try:
        cpu_state, cpu_mets = TA.make_analog_sgd_step(tcfg, lr=0.1)(
            state0_cpu, {"tokens": torch.from_numpy(x).long(),
                         "labels": torch.from_numpy(y).long()}, seeds[0])
    finally:
        K._read_plain, U._update_plain = read_plain, update_plain
    if next(replay_r, None) is not None or next(replay_w, None) is not None:
        fail("the CPU replay of train step 1 made fewer reads or writes")
    digital_over, digital_err = 0.0, 0.0
    init = dict(tree_leaves(state0_cpu["params"]))
    card = dict(tree_leaves(params1))
    for path, p_cpu in tree_leaves(cpu_state["params"]):
        if path[-1] in ("g", "ref", "w_scale"):
            continue
        move = (p_cpu - init[path]).abs()
        err = (card[path] - p_cpu).abs()
        bound = 1e-3 * move.max() + 1e-6
        digital_err = max(digital_err, err.max().item())
        digital_over = max(digital_over, (err.max() / bound).item())
        if (err > bound).any():
            fail(f"digital leaf {path} after train step 1: card vs CPU "
                 f"replay differ by {err.max().item()} (bound "
                 f"{bound.item()})")
    loss_diff = abs(float(cpu_mets["loss"]) - losses[0])

    tokens = 8 * 256
    warm = step_ms[1:]
    res = {"losses": losses, "g_rail_frac": rails, "step_ms": step_ms,
           "tokens_per_step": tokens,
           "tokens_per_s": tokens / (sum(warm) / len(warm) / 1e3),
           "launches_per_step": launches, "peak_memory_gb": peak_gb,
           "profile_step5": profile,
           "step1_reads_checked": n_reads, **{
               f"step1_reads_{k}": v for k, v in worst.items()},
           "step1_writes_checked": n_writes, **{
               f"step1_writes_{k}": v for k, v in upd.items()},
           "digital_leaves_max_abs_err_vs_cpu_replay": digital_err,
           "digital_leaves_max_err_over_bound": digital_over,
           "loss_card_vs_cpu_replay": loss_diff,
           "cost": step.cost}
    report(res)
    print(f"phase 7: lm100m trained 4 steps at full width: losses "
          f"{[round(v, 5) for v in losses]}, g_rail_frac {rails[-1]:.3g}, "
          f"{sum(warm) / len(warm):.1f} ms per warm step = "
          f"{res['tokens_per_s']:.0f} tokens/s, peak memory {peak_gb:.2f} "
          f"GB (steps 2-4, unrecorded); step 1: {n_reads} reads (worst "
          f"{worst['max_err_over_bound']:.3f} of the bound, flip share at "
          f"most {worst['max_flip_share']:.2g}) and {n_writes} writes "
          f"({upd['max_err_over_twin_bound']:.3f} of the twin's bound, "
          f"allowance share at most {upd['max_allowance_share']:.2g}) agree "
          f"with the plain versions; "
          f"digital leaves vs CPU replay {digital_err:.3g} "
          f"({digital_over:.3f} of the bound), loss differs by "
          f"{loss_diff:.3g}")
    return res


def reset_launches(K, U):
    for counts in (K.LAUNCHES, U.LAUNCHES):
        for name in counts:
            counts[name] = 0


def profile_train_step(K, U, syn, step, state, stream, rng, expect,
                       n_steps=1, shape=(8, 256), extras=None):
    """Device time of ``n_steps`` more training steps (from the fifth) by
    kernel, from torch.profiler, against their wall time, per step:
    reported only.  Batches of ``shape`` (B, S) tokens, with ``extras``
    (a cross-attention family's stream) where given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batches = []
    for i in range(n_steps):
        x, y = syn.batch_tokens(stream, *shape, 4 + i)
        batches.append(({"tokens": torch.from_numpy(x).long().cuda(),
                         "labels": torch.from_numpy(y).long().cuda(),
                         **(extras or {})},
                        int(torch.randint(0, 2 ** 32, (), generator=rng,
                                          device="cuda"))))
    reset_launches(K, U)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch, seed_base in batches:
            state, _ = step(state, batch, seed_base)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps
    got = {**K.LAUNCHES, **U.LAUNCHES}
    if got != {k: n_steps * v for k, v in expect.items()}:
        fail(f"profiled train steps launched {got}")

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # the first group whose key a kernel's name contains takes it
    groups = {"forward reads": ("tc_read_kernel<false",
                                "tc_range_kernel<false",
                                "fused_read_tile_kernel<false"),
              "transpose reads": ("tc_read_kernel<true",
                                  "tc_range_kernel<true",
                                  "fused_read_tile_kernel<true"),
              "read pre-passes": ("read_prepare_kernel",),
              "tile-order sums": ("reduce_tiles_kernel",),
              "write pre-passes": ("update_prepare_kernel",),
              "rank-k writes": ("tc_update_kernel<false",),
              "pulse-train writes": ("tc_update_kernel<true",),
              "rank-k writes (FP32 instance)": ("update_kernel<false",),
              "pulse-train writes (FP32 instance)": ("update_kernel<true",)}
    by = {g: 0.0 for g in groups}
    by["other (digital ops)"] = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        g = next((g for g, keys in groups.items()
                  if any(key in e.key for key in keys)),
                 "other (digital ops)")
        by[g] += dev_us(e) / 1e3 / n_steps
    busy = sum(by.values())
    res = {"steps": n_steps, "wall_ms": 1e3 * wall, "device_ms": busy,
           "idle_share": 1 - busy / (1e3 * wall) if busy else None,
           "device_ms_by_group": by}
    what = f"profiled train step{'s' if n_steps > 1 else ''} 5" + (
        f"-{4 + n_steps}, per step" if n_steps > 1 else "")
    if busy:
        print(f"  {what}: " + ", ".join(
            f"{g} {v:.2f} ms" for g, v in by.items() if v)
              + f"; device busy {busy:.1f} of {1e3 * wall:.1f} ms wall "
              f"(idle {100 * res['idle_share']:.1f}%)")
    else:
        print(f"  {what}: the profiler recorded no device time (not "
              f"measured)")
    return res


# --------------------------------------------------------------------------
# Phases 8-10: the fakequant read and fakequant serving
# --------------------------------------------------------------------------

def fq_exact_operands(t, k, n, gen):
    """Integer drives in [-2, 2] with max|x| = 127 (the DAC scale is then
    exactly 1) and weights in {-1, 0, 1}, seven in eight zero, the row the
    127 drives zero: every partial product and every per-tile sum of
    squares is an exact float32 integer below 2^24 (checked)."""
    dev = gen.device
    x = torch.randint(-2, 3, (t, k), generator=gen, device=dev).float()
    x[0, 0] = 127.0
    w = torch.randint(-1, 2, (k, n), generator=gen, device=dev).float()
    w *= (torch.rand((k, n), generator=gen, device=dev) < 0.125).float()
    w[0] = 0.0
    return x, w


def fq_tile_lsb(x, w, sc, adc, rows):
    """(T, tiles) ADC lsb of a fakequant read, from the plain pieces."""
    from repro_torch.core.adc import _clip, _round
    k = w.shape[0]
    lv = float(adc.in_levels)
    xq = _clip(_round(x / sc), -lv, lv) * sc
    lsbs = []
    for i in range(0, k, rows):
        q = xq[:, i:i + rows] @ w[i:i + rows]
        ms = (q * q).sum(-1) / w.shape[1]
        lsbs.append(adc.sat_sigmas * torch.sqrt(ms + 1e-12) / adc.out_levels)
    return torch.stack(lsbs, dim=1)


def fq_exact_ok(x, w, rows):
    """The exact class's premise: per-tile sums of squares below 2^24."""
    xd, wd = x.double(), w.double()
    worst = max(((xd[:, i:i + rows] @ wd[i:i + rows]) ** 2).sum(-1).max()
                .item() for i in range(0, w.shape[0], rows))
    return worst < 2 ** 24


def fq_agrees(y_k, y_p, x, w, sc, adc, rows):
    """The float class's bound: every element within one lsb per row tile
    (the token's own) of the plain version, plus 1e-5 of the larger of the
    two values, and under 1% of the elements more than 1e-5 relative off.
    The kernel's lsb is the plain version's up to the float32 rounding of
    the range sum, taken in another order; the relative term covers that
    difference, and it is taken of both values so that it also covers a
    code that flips between 0 and +-1, where the plain value is 0 and the
    kernel's is one lsb of its own.  Returns (ok, max abs err, largest err
    / bound, flip share)."""
    err = (y_k - y_p).abs()
    bound = fq_tile_lsb(x, w, sc, adc, rows).sum(1, keepdim=True) \
        + 1e-5 * torch.maximum(y_p.abs(), y_k.abs())
    share = (err > 1e-5 * y_p.abs().amax()).float().mean().item()
    ok = bool((err <= bound).all()) and share < 0.01
    return ok, err.max().item(), (err / bound).max().item(), share


#: The fakequant read's kernels (profiler names) by launch count.
FQ_KERNELS = {"fakequant_scale_kernel": "fakequant_scale",
              "fakequant_prepare_kernel": "fakequant_prepare",
              "fakequant_fp32_kernel": "fakequant_fp32",
              "fakequant_tc_kernel": "fakequant_tc",
              "fakequant_epilogue_kernel": "fakequant_epilogue"}


def fq_bounds(t, k, n):
    """A fakequant read's bounds, in ms: the bytes (x and W read once, y
    written once) at the HBM rate; the FP32 bound (the larger of the bytes
    and 2 T K N flops at the FP32 rate); the tensor-core floor (three bf16
    products at the bf16 rate, or the bytes)."""
    n_bytes = 4 * (t * k + k * n + t * n)
    flops = 2 * t * k * n
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return {"bytes_ms": 1e3 * t_bytes,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "tc_floor_ms": 1e3 * max(t_bytes, 3 * flops / BF16_FLOPS)}


def time_fakequant(K, x, w, sc, adc, rows, instance):
    """Device times of one instance of the kernel (whole, and each of its
    three kernels), its plain version and torch.matmul of the product
    ``xq @ W`` alone (not the same function), cycling over copies of the
    weights so each launch finds them out of L2; beside them the CUDA-event
    time of the read back to back (host launch cost included) and the
    bounds (:func:`fq_bounds`)."""
    t, k = x.shape
    n = w.shape[1]
    copies = max(2, min(64, math.ceil(3 * L2_BYTES / (4 * w.numel()))))
    ws = [w.clone() for _ in range(copies)]
    from repro_torch.core.adc import _clip, _round
    lv = float(adc.in_levels)
    xq = _clip(_round(x / sc), -lv, lv) * sc
    flops = 2 * t * k * n
    iters = max(copies, 50 if flops < 1e10 else 5)
    sync = torch.cuda.synchronize

    def kern(i):
        return K._fakequant_cuda(x, ws[i % copies], adc, rows, instance)

    def plain(i):
        return K._fakequant_plain(x, ws[i % copies], sc, adc, rows)

    def matmul(i):
        return torch.matmul(xq, ws[i % copies])
    pre, product = ("fakequant_prepare", "fakequant_tc") \
        if instance == "tensor_core" else ("fakequant_scale", "fakequant_fp32")
    ms, parts = device_ms(kern, iters, (pre, product, "fakequant_epilogue"))
    res = {"instance": instance, "ms": ms,
           "plain_ms": device_ms(plain, iters),
           "matmul_ms_not_the_same_function": device_ms(matmul, iters),
           "prepass_ms": parts[pre],
           "product_ms": parts[product],
           "epilogue_ms": parts["fakequant_epilogue"], "timing": "profiler",
           "events_ms": cuda_ms(kern, iters, sync)}
    if any(v is None for v in res.values()):
        fns = {"ms": kern, "plain_ms": plain,
               "matmul_ms_not_the_same_function": matmul}
        res.update({name: cuda_ms(fn, iters, sync)
                    for name, fn in fns.items()})
        res["timing"] = "events"
    res.update(fq_bounds(t, k, n))
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["tc_floor_share"] = res["tc_floor_ms"] / res["ms"]
    return res


# the wide case: gemma-2b's w_upgate (d_model 2048, 2 x 16384 columns)
FQ_WIDE = ("gemma-2b w_upgate", 2048, 32768)


def fq_case(K, name, t, k, n, tile, cls, gen, adc, timed):
    """One fakequant case on both instances: the exact class bit-equal to
    the plain version (and the tensor-core instance to its plain twin),
    the float class within ``fq_agrees``; the pre-pass's DAC scale
    bit-equal to ``fakequant_scale``.  Returns one row per instance."""
    if cls == "exact":
        x, w = fq_exact_operands(t, k, n, gen)
        if not fq_exact_ok(x, w, tile):
            fail(f"exact-class operands out of range: {name} T={t}")
    else:
        x = torch.randn((t, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    sc = K.fakequant_scale(x, adc.in_levels)
    if cls == "exact" and sc.item() != 1.0:
        fail(f"exact class: DAC scale {sc.item()} is not 1")
    y_p = K._fakequant_plain(x, w, sc, adc, tile)
    rows = []
    for instance in ("fp32", "tensor_core"):
        y_k, sc_k = K._fakequant_cuda(x, w, adc, tile, instance)
        torch.cuda.synchronize()
        row = {"projection": name, "T": t, "K": k, "N": n, "rows": tile,
               "class": cls, "instance": instance,
               "scale_equal": torch.equal(sc_k, sc),
               "max_abs_err": (y_k - y_p).abs().max().item()}
        if cls == "exact":
            ok = torch.equal(y_k, y_p)
        else:
            ok, _, row["err_over_bound"], row["flip_share"] = fq_agrees(
                y_k, y_p, x, w, sc, adc, tile)
        if instance == "tensor_core":
            y_t = K._fakequant_tc_plain(x, w, sc, adc, tile)
            row["twin_max_abs_err"] = (y_k - y_t).abs().max().item()
            if cls == "exact":
                row["twin_ok"] = torch.equal(y_k, y_t)
            else:
                row["twin_ok"], _, row["twin_err_over_bound"], _ = \
                    fq_agrees(y_k, y_t, x, w, sc, adc, tile)
            ok = ok and row["twin_ok"]
        row["ok"] = ok and row["scale_equal"]
        if timed and cls == "float":
            row.update(time_fakequant(K, x, w, sc, adc, tile, instance))
        rows.append(row)
        if not row["ok"]:
            fail(f"fakequant read disagrees with its plain version: {row}")
    return rows


def phase_fq_kernel(K, AdcConfig, report):
    """The fakequant read against its plain versions on the card, on both
    instances: lm100m's four projections at T = 4, 16 and 2048 with 1024-
    and 64-row tiles and at the instance threshold with 1024-row tiles, two
    ragged cases, and gemma-2b's w_upgate widths (K = 2048, N = 32768) at T
    = 4 and 2048.  Exact class bit-equal; float class within one lsb per
    row tile.  T = 4, the threshold and T = 2048 at 1024 rows are timed on
    both instances."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    adc = AdcConfig(in_bits=8, out_bits=8)
    cases = [(name, t, k, n, rows) for rows in (1024, 64)
             for t in (4, 16, 2048) for name, k, n in TRAIN_SHAPES]
    # the instance threshold, where the two instances cross
    cross = K.FQ_TC_MIN_TOKENS
    cases += [(name, cross, k, n, 1024) for name, k, n in TRAIN_SHAPES]
    # ragged: T, K, N and the tiles; N = 70 takes the FP32 instance's
    # scalar loads (N not a multiple of 4), 48-row tiles padded lines
    cases += [("ragged", 37, 200, 72, 64), ("ragged", 5, 200, 70, 48)]
    cases += [(FQ_WIDE[0], t, FQ_WIDE[1], FQ_WIDE[2], 1024) for t in (4, 2048)]
    rows_out = []
    for name, t, k, n, tile in cases:
        timed = tile == 1024 and t in (4, cross, 2048) and name != "ragged"
        for cls in ("exact", "float"):
            for row in fq_case(K, name, t, k, n, tile, cls, gen, adc, timed):
                rows_out.append(row)
                report(row)
    for r in rows_out:
        if "ms" in r:
            print(f"  fakequant {r['projection']} K={r['K']} N={r['N']} "
                  f"T={r['T']} ({r['instance']}): kernel {r['ms']:.4f} ms "
                  f"({r['timing']}; pre-pass {r['prepass_ms']:.4f}, product "
                  f"{r['product_ms']:.4f}, epilogue {r['epilogue_ms']:.4f}; "
                  f"events {r['events_ms']:.4f}), plain {r['plain_ms']:.4f} "
                  f"ms, torch.matmul of the product alone (not the same "
                  f"function) {r['matmul_ms_not_the_same_function']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                  f"{100 * r['bound_share']:.1f}% of it), tensor-core floor "
                  f"{r['tc_floor_ms']:.4f} ms ({100 * r['tc_floor_share']:.1f}"
                  f"%), max abs err {r['max_abs_err']:.3g}")
    for t in (4, cross, 2048):
        for inst in ("fp32", "tensor_core"):
            lay = fq_rows_of(rows_out, t, inst)
            print(f"  one lm100m layer's four fakequant reads at T={t} "
                  f"({inst}): {sum(r['ms'] for r in lay):.4f} ms, plain "
                  f"{sum(r['plain_ms'] for r in lay):.4f} ms, bound "
                  f"{sum(r['bound_ms'] for r in lay):.4f} ms, tensor-core "
                  f"floor {sum(r['tc_floor_ms'] for r in lay):.4f} ms")
    print(f"phase 8: {len(rows_out)} fakequant-read cases agree (both "
          f"instances, each of {len(cases)} shapes in two classes)")
    return rows_out


@contextlib.contextmanager
def counting_plain(K, OPS, calls):
    """Count calls of the fakequant read's plain versions (the kernel's
    and the projection's jnp-path twin)."""
    plain, eager = K._fakequant_plain, OPS._fakequant_eager

    def count_plain(*args):
        calls.append("kernel plain version")
        return plain(*args)

    def count_eager(*args):
        calls.append("projection plain path")
        return eager(*args)
    K._fakequant_plain, OPS._fakequant_eager = count_plain, count_eager
    try:
        yield
    finally:
        K._fakequant_plain, OPS._fakequant_eager = plain, eager


def phase_fq_serve(M, K, OPS, make_engine, SamplingParams, fcfg, prompts,
                   report):
    """lm100m at full width in fakequant mode (1024-row tiles, 8-bit
    DAC/ADC, random weights from torch.Generator seed 0), served from its
    digital tree by the continuous scheduler with phase 2's settings.
    Gates: 48 fakequant reads per model call, each three counted launches
    (the FP32 instance's scale and product, the epilogue) and none of the
    tensor-core instance, and no call of a plain version."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = M.init_params(fcfg, gen, device="cuda")
    engine = make_engine(fcfg, params, n_slots=4, prefill_chunk=16,
                         max_len=64)
    if engine.backend != "digital":
        fail(f"fakequant engine on backend {engine.backend!r}")
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))  # warm-up
    torch.cuda.synchronize()
    plain_calls = []
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    with counting_plain(K, OPS, plain_calls):
        t0 = time.perf_counter()
        outs = engine.generate(prompts, SamplingParams(max_new_tokens=32))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    m = engine.stream.metrics
    calls = m["prefill_chunks"] + m["decode_steps"]
    launches = dict(K.LAUNCHES)
    n_tok = sum(len(o) for o in outs)
    per_call = 4 * fcfg.n_layers
    res = {"tokens": n_tok, "seconds": dt, "tokens_per_s": n_tok / dt,
           "model_calls": calls, "prefill_chunks": m["prefill_chunks"],
           "decode_steps": m["decode_steps"], "launches": launches,
           "plain_calls": len(plain_calls)}
    reads = launches["fakequant"]
    by_kernel = {name: launches[count] for name, count in FQ_KERNELS.items()}
    res["launches_by_kernel"] = by_kernel
    res["launches_per_read"] = sum(by_kernel.values()) / max(reads, 1)
    print(f"fakequant serving: {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tokens/s ({calls} model calls, {reads} "
          f"fakequant reads; launches by kernel {by_kernel}, "
          f"{res['launches_per_read']:.2f} a read; {len(plain_calls)} "
          f"plain-version calls)")
    # every read: the FP32 instance's scale and product (decode and
    # 16-token prefill chunks) and the epilogue, each counted at its launch
    want = {"fakequant_scale_kernel": reads, "fakequant_prepare_kernel": 0,
            "fakequant_fp32_kernel": reads, "fakequant_tc_kernel": 0,
            "fakequant_epilogue_kernel": reads}
    if reads != per_call * calls or calls == 0 or by_kernel != want:
        fail(f"fakequant serving launched {launches} for {calls} model "
             f"calls; expected {per_call * calls} reads, each {want}")
    if any(v for name, v in launches.items() if "fakequant" not in name):
        fail(f"fakequant serving launched crossbar reads: {launches}")
    if plain_calls:
        fail(f"fakequant serving on the card called a plain version "
             f"{len(plain_calls)} times")
    if [len(o) for o in outs] != [32] * 4 or \
            not all(0 <= t < fcfg.vocab for o in outs for t in o):
        fail(f"bad fakequant outputs {outs}")
    res["profile"] = profile_decode_step(M, fcfg, params)
    report(res)
    return params, res


def profile_decode_step(M, cfg, params, what="fakequant",
                        keys=("fakequant_",), max_len=32, extras=None):
    """Device time of one decode step (B = 4, a cache of ``max_len``) by
    kernel, from torch.profiler, beside its unprofiled wall time, and the
    share of the kernels whose names contain one of ``keys`` (``what``):
    reported only.  ``extras`` is a cross-attention family's stream (B =
    4), given to the prefill and to every decode step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 12))).cuda()
    extras = extras or {}
    with torch.no_grad():
        logits, cache = M.prefill(params, {"tokens": toks, **extras}, cfg,
                                  max_len)
        tok = logits.argmax(-1)
        for _ in range(2):
            logits, cache = M.decode_step(params, cache, tok, cfg, extras)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = M.decode_step(params, cache, tok, cfg, extras)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            logits, cache = M.decode_step(params, cache, tok, cfg, extras)
            torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU]
    total = kernel_us(prof)
    read = sum(dev_us(e) for e in events if any(k in e.key for k in keys))
    res = {"wall_ms": 1e3 * wall, "device_ms": total / 1e3,
           f"{what}_read_ms": read / 1e3,
           "idle_share": (1 - total / 1e6 / wall) if total else None}
    if total:
        print(f"  profiled {what} decode step (B=4): device "
              f"{res['device_ms']:.3f} ms ({res[f'{what}_read_ms']:.3f} "
              f"in the {what} read) of {res['wall_ms']:.3f} ms wall, "
              f"idle {100 * res['idle_share']:.1f}%")
    else:
        print(f"  profiled {what} decode step: the profiler recorded no "
              "device time (not measured)")
    return res


@contextlib.contextmanager
def recording_fq(K, reads):
    """Record every fakequant read the kernels run: ``(x, w, sc, adc,
    rows, y)``, ``sc`` the scale the pre-pass computed."""
    fq_cuda = K._fakequant_cuda

    def recorded(x, w, adc, rows, instance=None):
        y, sc = fq_cuda(x, w, adc, rows, instance)
        reads.append((x.clone(), w, sc.clone(), adc, rows, y.clone()))
        return y, sc

    K._fakequant_cuda = recorded
    try:
        yield
    finally:
        K._fakequant_cuda = fq_cuda


def phase_fq_card_vs_cpu(M, K, OPS, fcfg, params, report):
    """The fakequant model's weights and tokens on the card and the CPU:
    prefill of a (4, 12) batch and 4 greedy decode steps.  Gates: (a)
    every read of the card's run against the kernel's plain version on
    the CPU fed the card's own operands (phase 8's bound); (b) the card's
    logits against the CPU's with the card's read results replayed into
    the CPU run, within 1e-3; (c) the free-running CPU, a gross check
    within twice the fakequant read's own error (fakequant vs float32
    digital logits)."""
    cpu_params = tree_to(params, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, fcfg.vocab, (4, 12)))
    reads = []
    with recording_fq(K, reads):
        card, fed = run_steps(M, params, fcfg, toks, None)
    dig, _ = run_steps(M, params, fcfg.digital(), toks, fed)
    cpu, _ = run_steps(M, cpu_params, fcfg, toks, fed)
    replay = iter(reads)
    eager = OPS._fakequant_eager

    def replayed(x, w, adc, rows):
        y = next(replay)[5]
        want = (x.reshape(-1, x.shape[-1]).shape[0], w.shape[1])
        if tuple(y.shape) != want:
            fail(f"replayed fakequant read of shape {tuple(y.shape)} for x "
                 f"{tuple(x.shape)} w {tuple(w.shape)}")
        return y.cpu().reshape(*x.shape[:-1], w.shape[1])

    OPS._fakequant_eager = replayed
    try:
        forced, _ = run_steps(M, cpu_params, fcfg, toks, fed)
    finally:
        OPS._fakequant_eager = eager
    if next(replay, None) is not None:
        fail("the CPU run made fewer fakequant reads than the card's")
    moved = {}
    worst = {"max_abs_err": 0.0, "max_err_over_bound": 0.0,
             "max_flip_share": 0.0}
    for x, w, sc, adc, rows, y in reads:
        key = (w.data_ptr(), tuple(w.shape))
        if key not in moved:
            moved[key] = w.cpu()
        x, w, sc = x.cpu(), moved[key], sc.cpu()
        if not torch.equal(sc, K.fakequant_scale(x, adc.in_levels)):
            fail(f"the card's DAC scale {sc} differs from the CPU's")
        y_p = K._fakequant_plain(x, w, sc, adc, rows)
        ok, err, over, share = fq_agrees(y.cpu(), y_p, x, w, sc, adc, rows)
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["max_err_over_bound"] = max(worst["max_err_over_bound"], over)
        worst["max_flip_share"] = max(worst["max_flip_share"], share)
        if not ok:
            fail(f"a fakequant read of the card's run disagrees with the "
                 f"plain version on its operands: x {tuple(x.shape)} w "
                 f"{tuple(w.shape)}, max err {err}, err/bound {over}, flip "
                 f"share {share}")
    gap = max_diff(card, dig)
    res = {"reads_checked": len(reads), **worst,
           "forced_max_abs_logit_diff": max_diff(card, forced),
           "forced_bound": 1e-3,
           "max_abs_logit": max(t.abs().max().item() for t in card),
           "max_abs_logit_diff": max_diff(card, cpu),
           "fakequant_vs_digital": gap, "bound": 2 * gap,
           "greedy_agree": [torch.equal(a.argmax(-1), b.argmax(-1))
                            for a, b in zip(card, cpu)]}
    report(res)
    print(f"fakequant card vs CPU: {len(reads)} reads agree with the plain "
          f"version on their operands (max abs err "
          f"{worst['max_abs_err']:.3g}, {worst['max_err_over_bound']:.3f} of "
          f"the one-lsb-per-tile bound, flip share at most "
          f"{worst['max_flip_share']:.2g}); replayed logits differ by "
          f"{res['forced_max_abs_logit_diff']:.3g} (bound 1e-3, logits up to "
          f"{res['max_abs_logit']:.3g}); free-running CPU "
          f"{res['max_abs_logit_diff']:.6f} (gross bound {2 * gap:.6f}); "
          f"greedy tokens agree per step {res['greedy_agree']}")
    if len(reads) != 5 * 4 * fcfg.n_layers:
        fail(f"{len(reads)} fakequant reads in a prefill and 4 decode steps")
    if not res["forced_max_abs_logit_diff"] <= 1e-3:
        fail(f"fakequant card and CPU logits differ with the reads "
             f"replayed: {res}")
    if not res["max_abs_logit_diff"] <= 2 * gap:
        fail(f"fakequant card and CPU logits differ beyond the bound: {res}")
    return res


def phase_fq_prefill(M, K, OPS, fcfg, params, report):
    """Phase 10(b): one full-width lm100m fakequant forward on the card at
    batch 1 x 2048 tokens, through ``M.forward`` (not the engine).  Gates:
    48 reads, each three counted launches with the product on the
    tensor-core instance (none on the FP32 one); every read against the
    plain version on the card on its own operands (phase 8's bound), its
    DAC scale bit-equal to ``fakequant_scale``; the card's logits against
    a CPU forward with the card's read results replayed, within 1e-3.  A
    second, unrecorded forward gives the wall time; a third, profiled,
    the device time and the reads' share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, fcfg.vocab, (1, 2048)))
    batch = {"tokens": toks.cuda()}
    reads = []
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    with torch.no_grad():
        with recording_fq(K, reads):
            card, _ = M.forward(params, batch, fcfg)
        torch.cuda.synchronize()
        launches = {name: K.LAUNCHES[count]
                    for name, count in FQ_KERNELS.items()}
        n_reads = K.LAUNCHES["fakequant"]
        t0 = time.perf_counter()
        M.forward(params, batch, fcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            M.forward(params, batch, fcfg)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU]
    read_ms = per_call_us([e for e in events if "fakequant_" in e.key],
                          1) / 1e3
    device = kernel_us(prof) / 1e3
    per = 4 * fcfg.n_layers
    want = {"fakequant_scale_kernel": 0, "fakequant_prepare_kernel": per,
            "fakequant_fp32_kernel": 0, "fakequant_tc_kernel": per,
            "fakequant_epilogue_kernel": per}
    if n_reads != per or len(reads) != per or launches != want:
        fail(f"the 2048-token fakequant forward made {n_reads} reads "
             f"({len(reads)} recorded), launches {launches}; expected {want}")
    worst = {"max_abs_err": 0.0, "max_err_over_bound": 0.0,
             "max_flip_share": 0.0}
    for x, w, sc, adc, rows, y in reads:
        if not torch.equal(sc, K.fakequant_scale(x, adc.in_levels)):
            fail("a prefill read's DAC scale differs from fakequant_scale")
        y_p = K._fakequant_plain(x, w, sc, adc, rows)
        ok, err, over, share = fq_agrees(y, y_p, x, w, sc, adc, rows)
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["max_err_over_bound"] = max(worst["max_err_over_bound"], over)
        worst["max_flip_share"] = max(worst["max_flip_share"], share)
        if not ok:
            fail(f"a prefill fakequant read disagrees with the plain "
                 f"version on its operands: x {tuple(x.shape)} w "
                 f"{tuple(w.shape)}, max err {err}, err/bound {over}, flip "
                 f"share {share}")
    replay = iter(reads)
    eager = OPS._fakequant_eager

    def replayed(x, w, adc, rows):
        y = next(replay)[5]
        return y.cpu().reshape(*x.shape[:-1], w.shape[1])

    OPS._fakequant_eager = replayed
    try:
        with torch.no_grad():
            cpu, _ = M.forward(tree_to(params, "cpu"), {"tokens": toks},
                               fcfg)
    finally:
        OPS._fakequant_eager = eager
    if next(replay, None) is not None:
        fail("the CPU forward made fewer fakequant reads than the card's")
    diff = (card.cpu() - cpu).abs().max().item()
    res = {"tokens": 2048, "reads": n_reads, "launches_by_kernel": launches,
           **worst, "forced_max_abs_logit_diff": diff, "forced_bound": 1e-3,
           "max_abs_logit": card.abs().max().item(),
           "finite": bool(torch.isfinite(card).all()), "wall_ms": 1e3 * wall,
           "device_ms": device, "fakequant_read_ms": read_ms}
    report(res)
    print(f"phase 10(b): lm100m fakequant forward, 1 x 2048 tokens: "
          f"{n_reads} reads on the tensor-core instance (launches "
          f"{launches}) agree with the plain version on their operands (max "
          f"abs err {worst['max_abs_err']:.3g}, "
          f"{worst['max_err_over_bound']:.3f} of the bound, flip share at "
          f"most {worst['max_flip_share']:.2g}); logits vs the CPU replay "
          f"{diff:.3g} (bound 1e-3); {1e3 * wall:.2f} ms wall, device "
          f"{device:.3f} ms of which the reads {read_ms:.3f} ms")
    if not res["finite"] or not diff <= 1e-3:
        fail(f"the 2048-token fakequant forward's logits: {res}")
    return res


# --------------------------------------------------------------------------
# Phase 11: flash attention
# --------------------------------------------------------------------------

# name, B, Sq, Skv, H, KVH, hd, causal: the registry's attention shapes
FA_CASES = [("lm100m", 1, 2048, 2048, 12, 12, 64, True),
            ("starcoder2-3b", 1, 2048, 2048, 24, 2, 128, True),
            ("gemma-2b", 1, 1024, 1024, 8, 1, 256, True),
            ("lm100m_full_cross", 1, 512, 2048, 12, 12, 64, False)]
FA_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def time_attention(FA, q, k, v, causal):
    """Device times of the kernel, the plain version and
    scaled_dot_product_attention (the same function: the library yardstick,
    never called by the port), by torch.profiler and by CUDA events."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sync = torch.cuda.synchronize
    fns = {"ms": lambda i: FA._flash_cuda(q, k, v, causal),
           "plain_ms": lambda i: FA.flash_attention_ref(q, k, v, causal),
           "library_ms": lambda i: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=causal, enable_gqa=True)}
    events = {name: cuda_ms(fn, 10, sync) for name, fn in fns.items()}
    res = {name: device_ms(fn, 10) for name, fn in fns.items()}
    res["timing"] = "profiler"
    if any(t is None for t in res.values()):  # the profiler saw no kernel
        res = dict(events)
        res["timing"] = "events"
    res.update({f"events_{name}": t for name, t in events.items()})
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    flops = 4 * b * h * sq * skv * hd * (0.5 if causal else 1.0)
    n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    rate = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / rate
    res["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    res["bound_share"] = res["bound_ms"] / res["ms"]
    # the tensor-core floor: bf16 products at their rate, float32 ones as
    # the kernel's three TF32 products
    t_tc = flops / BF16_FLOPS if q.dtype == torch.bfloat16 \
        else 3 * flops / TF32_FLOPS
    res["tc_floor_ms"] = 1e3 * max(t_bytes, t_tc)
    res["tc_floor_share"] = res["tc_floor_ms"] / res["ms"]
    return res


def phase_flash(FA, report):
    """Flash attention at the registry's attention shapes, in float32 and
    bfloat16.  The path is the function itself (nothing on the model path
    calls it, as in the reference): every case runs through the public
    ``flash_attention`` with the count set to 0 first; then each output is
    held against the plain version on the card (1e-4 float32, 3e-2
    bfloat16, the reference test's tolerances), and the kernel, the plain
    version and scaled_dot_product_attention are timed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    inputs = []
    for case in FA_CASES:
        name, b, sq, skv, h, kvh, hd, causal = case
        base = [torch.randn(shape, generator=gen, device="cuda")
                for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                              (b, skv, kvh, hd))]
        for dtype in (torch.float32, torch.bfloat16):
            inputs.append((case, dtype, [t.to(dtype) for t in base]))
    FA.LAUNCHES["flash_attention"] = 0
    outs = [FA.flash_attention(*qkv, causal=case[-1])
            for case, _, qkv in inputs]
    torch.cuda.synchronize()
    launches = FA.LAUNCHES["flash_attention"]
    if launches != len(inputs):
        fail(f"flash attention launched {launches} times for "
             f"{len(inputs)} calls")
    rows = []
    for (case, dtype, (q, k, v)), out in zip(inputs, outs):
        name, b, sq, skv, h, kvh, hd, causal = case
        ref = FA.flash_attention_ref(q, k, v, causal).float()
        err = (out.float() - ref).abs()
        tol = FA_TOL[dtype]
        ok = out.dtype == dtype and bool(torch.isfinite(out).all()) \
            and bool((err <= tol + tol * ref.abs()).all())
        row = {"case": name, "B": b, "Sq": sq, "Skv": skv, "H": h,
               "KVH": kvh, "hd": hd, "causal": causal,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err.max().item(), "tol": tol, "ok": ok}
        row.update(time_attention(FA, q, k, v, causal))
        rows.append(row)
        report(row)
        print(f"  flash attention {name} {row['dtype']} (B={b}, Sq={sq}, "
              f"Skv={skv}, H={h}, KVH={kvh}, hd={hd}, causal={causal}): "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"sdpa {row['library_ms']:.4f} ms ({row['timing']}; events "
              f"kernel {row['events_ms']:.4f}, sdpa "
              f"{row['events_library_ms']:.4f}), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{100 * row['bound_share']:.2f}% of bound), tensor-core "
              f"floor {row['tc_floor_ms']:.4f} ms "
              f"({100 * row['tc_floor_share']:.2f}% of it), max abs err "
              f"{row['max_abs_err']:.3g} (tol {tol})")
        if not ok:
            fail(f"flash attention disagrees with its plain version: {row}")
    print(f"phase 11: {len(rows)} flash-attention cases agree "
          f"({launches} launches through flash_attention)")
    return rows, launches


# --------------------------------------------------------------------------
# Phases 12-13: pulse-train writes, periodic carry, the nonideality point
# --------------------------------------------------------------------------

def pulse_agrees(g_k, g_p, g, x_q, d_q, scale, cfg, z):
    """The float class of a pulse-train write: every cell of ``g_k``
    within 4 float32 ulp plus 1e-5 of its own move of ``g_p`` (the plain
    version), or a tie cell — a rail's ``mag / pulse_dg``, recomputed by
    the plain version, within 1e-4 relative of a half-integer — within
    one event (``pulse_dg * max(up, dn)``) plus the sigma change plus that
    slack; under 1e-3 of the cells use the tie allowance.  ``z`` is the
    write's standard-normal field (None if noiseless).  A count off by
    one away from a tie, a swapped rail or a wrong hash fail.  Returns
    (ok, max abs err, largest err / 4-ulp bound among the cells within
    it, share of cells that used the tie allowance)."""
    from repro_torch.kernels.xbar_update import _updown_factors
    dev = cfg.device
    m = scale[:, None, None]
    acc = torch.einsum("lbk,lbn->lkn", x_q, d_q)
    a_abs = torch.einsum("lbk,lbn->lkn", x_q.abs(), d_q.abs())
    tie = torch.zeros_like(g, dtype=torch.bool)
    n = torch.zeros_like(g)
    for sgn in (1.0, -1.0):
        v = (0.5 * (a_abs * m.abs() + sgn * acc * m)).clamp(min=0) \
            / dev.pulse_dg
        tie |= (v - torch.floor(v) - 0.5).abs() <= 1e-4 * v.abs()
        n += torch.round(v)
    del acc, a_abs
    if dev.kind in ("ideal", "linearized"):
        event = torch.full_like(g, dev.pulse_dg)
    else:
        up, dn = _updown_factors(g, dev)
        event = dev.pulse_dg * torch.maximum(up, dn)
    slack = 4 * 2.0 ** -24 + 1e-5 * (g_p - g).abs()
    err = (g_k - g_p).abs()
    close = err <= slack
    tie_bound = event + slack
    if z is not None:
        dsig = dev.write_noise * dev.pulse_dg * torch.maximum(
            torch.sqrt(n + 1) - torch.sqrt(n),
            torch.sqrt(n) - torch.sqrt(torch.clamp(n - 1, min=0)))
        tie_bound = tie_bound + dsig * z.abs()
    flips = ~close
    share = flips.float().mean().item()
    ok = bool((close | (tie & (err <= tie_bound))).all()) and share < 1e-3
    over = (err[close] / slack[close]).max().item() if close.any() else 0.0
    return ok, err.max().item(), over, share


def profiled_kernel(fn, n_iter, name):
    """torch.profiler's device time per call of the kernels whose names
    contain ``name`` (None if it recorded none) and how many such kernel
    events it recorded in ``n_iter`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_iter):
            fn(i)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and name in e.key]
    us = per_call_us(events, n_iter)
    return (us / 1e3 if us > 0 else None, sum(e.count for e in events))


def pulse_operands(lyr, k, n, t, gen, case):
    """Operands of a pulse-train write: ``update_operands`` (power-of-two
    scales in the exact class, lm100m's regime otherwise), with the row
    drives leaning positive and the column drives negative in the
    ``skewed`` case, so that the SET and RESET rails differ: float
    operands, no longer codes times scales (their scales are None)."""
    g, x_q, d_q, scale, xs, ds = update_operands(lyr, k, n, t, gen,
                                                 case == "ideal")
    if case == "ideal":   # several events per cell: m = -2^-2, still exact
        scale = torch.full_like(scale, -0.25)
    if case == "skewed":
        x_q, d_q, xs, ds = x_q + 1.0, d_q - 1e-4, None, None
    return g, x_q, d_q, scale, xs, ds


def phase_pulse_update(U, TAOX, IDEAL, CrossbarConfig, report):
    """The pulse-train write against its plain versions on the card, at
    each container's (12, K, N) with T = 2048 and 64x64 tiles, through the
    tensor-core instance: (a) ideal device, no noise, power-of-two scales,
    bit-equal; (b) TaOx, counter-PRNG noise and (c) TaOx, host noise
    field, ``tc_write_agrees`` (``pulse_agrees`` against the plain
    version).  The FP32 instance runs the (b) cases (``pulse_agrees``), a
    ragged case (asymmetric TaOx, skewed float drives, 48x63 tiles: FP32
    only) and 1024x1024 tiles (both).  The (b) cases are timed by CUDA
    events, as phase 6, against the floors (two accumulates, 4 T K N
    flops per layer), beside torch.bmm of the two accumulates alone (not
    the same function); the profiler's time of the tensor-core kernel and
    its count of kernel events beside them."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    asym = TAOX.replace(nu_set=3.0, nu_reset=6.0, gain_set=1.3,
                        gain_reset=0.7)
    cases = [(name, 12, k, n, 2048, case, 64, 64,
              IDEAL if case == "ideal" else TAOX)
             for name, k, n in TRAIN_SHAPES
             for case in ("ideal", "kernel", "host")]
    cases += [("ragged", 2, 200, 72, 37, "skewed", 48, 63, asym),
              ("tile1024", 12, 768, 2304, 2048, "kernel", 1024, 1024, TAOX)]
    rows = []
    for name, lyr, k, n, t, case, tr, tc, dev in cases:
        cfg = CrossbarConfig(rows=tr, cols=tc, device=dev,
                             update_mode="pulse_train")
        g, x_q, d_q, scale, xs, ds = pulse_operands(lyr, k, n, t, gen, case)
        noise = torch.randn(g.shape, generator=gen, device="cuda") \
            if case == "host" else None
        seed = None if case in ("ideal", "host") else 0x5EED1234
        mode = {"ideal": "none", "host": "host"}.get(case, "kernel")
        timed = case == "kernel" and tr == 64
        row = {"container": name, "L": lyr, "K": k, "N": n, "T": t,
               "tile": [tr, tc], "case": case}
        row.update(write_case(U, g, x_q, d_q, scale, xs, ds, noise, seed,
                              mode, cfg, exact=case == "ideal",
                              fp32=case == "kernel", timed=timed))
        if row["max_move"] <= dev.pulse_dg:
            fail(f"pulse-train write case moved no cell by an event: {row}")
        if timed:
            row["profiler_ms"], row["profiler_kernel_events"] = \
                profiled_kernel(
                    lambda i: U.xbar_outer_update(
                        g, x_q, d_q, scale, cfg, seed=seed, noise_mode=mode,
                        x_scale=xs, d_scale=ds),
                    5, "tc_update_kernel<true")
            print_write(f"pulse update {name}", row)
            print(f"    profiler: {row['profiler_ms']} ms over "
                  f"{row['profiler_kernel_events']} kernel events")
        rows.append(row)
        report(row)
        del g, x_q, d_q, noise
    print(f"phase 12: {len(rows)} pulse-train write cases agree "
          f"(tensor-core instance in {sum('prepass_ok' in r for r in rows)},"
          f" FP32 instance in {sum('fp32_ok' in r for r in rows)})")
    return rows


@contextlib.contextmanager
def counting_calls(module, names, calls):
    """Count calls of ``module``'s functions ``names`` (the plain versions)
    while the block runs."""
    saved = {name: getattr(module, name) for name in names}

    def counted(name):
        def fn(*args, **kw):
            calls.append(name)
            return saved[name](*args, **kw)
        return fn
    for name in names:
        setattr(module, name, counted(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def carry_cfg(tcfg, period, mode):
    return tcfg.replace(analog_carry=True, carry_period=period,
                        analog_carry_base=4.0, analog_update_mode=mode)


def sweep_agrees(card, cpu, xcfg):
    """The carry-sweep class, per container: the card's swept ``g`` and
    ``g_carry`` bit-equal to the CPU's sweep of the same pre-sweep
    containers, or one ADC code apart (``w_swing / out_levels`` on the
    carry array, a quarter of it on the primary) where ``v / lsb`` sits at
    a rounding boundary, under 1e-3 of the cells.  Returns (ok, max abs
    err, share of cells that differ)."""
    lsb = xcfg.w_swing / xcfg.adc.out_levels
    worst, moved, cells = 0.0, 0, 0
    ok = True
    for path, c in tree_leaves(card):
        if path[-1] not in ("g", "g_carry"):
            continue
        want = dict(tree_leaves(cpu))[path]
        err = (c.cpu() - want).abs()
        code = lsb / xcfg.carry_base if path[-1] == "g" else lsb
        ok &= bool((err <= code + 4 * 2.0 ** -24).all())
        worst = max(worst, err.max().item())
        moved += int((err > 0).sum())
        cells += err.numel()
    return ok and moved < 1e-3 * cells, worst, moved / cells


def phase_carry_train(K, U, TA, M, syn, tcfg, report):
    """lm100m at full width trained with periodic carry (period 2, base
    4) and pulse-train writes: ``init_state`` from torch.Generator seed 0,
    4 steps on phase 7's batches.

    Gates: 48 forward and 48 transpose reads and 4 pulse-train writes per
    step (each on the tensor-core instance with its pre-pass, none on the
    FP32 instance), no outer write and no call of a plain version; every
    write of step 1 against its plain versions on the card on its own
    operands, scales included (``check_writes``: ``pulse_agrees`` against
    the plain version); step 1 leaves every primary array untouched and
    step 2's sweep moves it; the card's sweep at step 2 against the CPU's
    sweep of the card's own pre-sweep containers (``sweep_agrees``), with
    ``effective_g`` conserved within 1e-6; finite losses and conductances
    in the window.  The step time, tokens/s and peak memory come from
    steps 3-4; two more steps (5, and 6 with a sweep) are profiled."""
    from repro_torch.core.tiled_analog import effective_g
    cfg = carry_cfg(tcfg, 2, "pulse_train")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = TA.init_state(gen, cfg, device="cuda")
    init = dict(tree_leaves(state["params"]))
    step = TA.make_analog_sgd_step(cfg, lr=0.1)
    xcfg = step.xcfg
    stream = syn.make_token_stream(200_000, cfg.vocab, seed=0)
    rng = torch.Generator(device="cuda")
    rng.manual_seed(1)
    n_layers = cfg.n_layers
    expect = tensor_core_train_expect(
        n_layers, fakequant=0, **dict.fromkeys(FQ_KERNELS.values(), 0),
        outer_update=0,
        pulse_update=4, update_tc=4, update_prepare=4, update_fp32=0)
    writes, swept, plain_calls = [], [], []
    update_cuda, sweep = U._update_cuda, step._carry_sweep
    rec_write = recording_writes(U, writes)

    def rec_sweep(p):
        swept.append(p)
        return sweep(p)
    step._carry_sweep = rec_sweep

    losses, step_ms, launches = [], [], []
    for i in range(4):
        x, y = syn.batch_tokens(stream, 8, 256, i)
        batch = {"tokens": torch.from_numpy(x).long().cuda(),
                 "labels": torch.from_numpy(y).long().cuda()}
        seed_base = int(torch.randint(0, 2 ** 32, (), generator=rng,
                                      device="cuda"))
        reset_launches(K, U)
        U._update_cuda = rec_write if i == 0 else update_cuda
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with counting_calls(U, ["_update_plain", "_update_tc_plain",
                                    "_update_codes_plain"], plain_calls), \
                    counting_calls(K, ["_read_plain"], plain_calls):
                state, mets = step(state, batch, seed_base)
                torch.cuda.synchronize()
        finally:
            U._update_cuda = update_cuda
        step_ms.append(1e3 * (time.perf_counter() - t0))
        got = {**K.LAUNCHES, **U.LAUNCHES}
        launches.append(got)
        losses.append(float(mets["loss"]))
        print(f"  carry+pulse train step {i + 1}: loss {losses[-1]:.5f}, "
              f"g_rail_frac {float(mets['g_rail_frac']):.3g}, "
              f"{step_ms[-1]:.1f} ms, launches {got}")
        if got != expect:
            fail(f"carry+pulse train step {i + 1} launched {got}; expected "
                 f"{expect}")
        if plain_calls:
            fail(f"carry+pulse train step {i + 1} called plain versions: "
                 f"{sorted(set(plain_calls))}")
        if not math.isfinite(losses[-1]):
            fail(f"carry+pulse train step {i + 1}: loss {losses[-1]}")
        params = state["params"]
        g_moved = max((leaf - init[path]).abs().max().item()
                      for path, leaf in tree_leaves(params)
                      if path[-1] == "g")
        if i == 0:
            if swept or g_moved != 0.0:
                fail("step 1 of the carry run moved a primary array")
            worst = check_writes(U, writes, "carry+pulse train step 1")
            n_writes = len(writes)
            writes.clear()
        if i == 1:
            if len(swept) != 1 or g_moved == 0.0:
                fail(f"step 2 of the carry run: {len(swept)} sweeps, "
                     f"primaries moved by {g_moved}")
            pre = swept[0]
            cpu_sweep = TA.make_analog_sgd_step(cfg, lr=0.1)._carry_sweep(
                tree_to(pre, "cpu"))
            sw_ok, sw_err, sw_share = sweep_agrees(params, cpu_sweep, xcfg)
            del cpu_sweep
            eff_err = 0.0
            for blk, name in (("attn", "wqkv"), ("attn", "wo"),
                              ("ffn", "w_upgate"), ("ffn", "w_down")):
                before = effective_g(pre["layers"][blk][name], xcfg)
                after = effective_g(params["layers"][blk][name], xcfg)
                eff_err = max(eff_err, (after - before).abs().max().item())
            swept.clear()
            del pre
            if not sw_ok or eff_err > 1e-6:
                fail(f"carry sweep of step 2: card vs CPU max err {sw_err}, "
                     f"share {sw_share}; effective_g moved by {eff_err}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for path, g in tree_leaves(state["params"]):
        if path[-1] in ("g", "g_carry") and not (g.min() >= 0
                                                 and g.max() <= 1):
            fail(f"conductances of {path} left the window")
    profile = profile_train_step(K, U, syn, step, state, stream, rng,
                                 expect, n_steps=2)
    step._carry_sweep = sweep
    tokens = 8 * 256
    warm = step_ms[2:]
    res = {"losses": losses, "step_ms": step_ms, "tokens_per_step": tokens,
           "tokens_per_s": tokens / (sum(warm) / len(warm) / 1e3),
           "launches_per_step": launches, "peak_memory_gb": peak_gb,
           "profile_steps5_6": profile, "step1_writes_checked": n_writes,
           **{f"step1_writes_{k}": v for k, v in worst.items()},
           "sweep_card_vs_cpu_max_abs_err": sw_err,
           "sweep_card_vs_cpu_differing_share": sw_share,
           "sweep_effective_g_max_change": eff_err}
    report(res)
    print(f"phase 13(a): lm100m trained 4 steps with carry (period 2) and "
          f"pulse-train writes: losses {[round(v, 5) for v in losses]}, "
          f"{sum(warm) / len(warm):.1f} ms per step = "
          f"{res['tokens_per_s']:.0f} tokens/s, peak memory {peak_gb:.2f} "
          f"GB (steps 3-4); step 1: {n_writes} writes agree with the plain "
          f"versions (tie share at most {worst['max_allowance_share']:.2g}, "
          f"{worst['max_err_over_twin_bound']:.3f} of the twin's bound); the "
          f"sweep of step 2 vs the CPU's: max err {sw_err:.3g}, "
          f"{sw_share:.2g} of the cells differ; effective_g conserved "
          f"within {eff_err:.3g}")
    return res


def phase_nonideality(U, K, TA, TL, TO, M, syn, tcfg, report, steps):
    """The reference's nonideality study at one point, write noise x64
    (``taox:wn64``), carry period 4 and base 4: the numeric run
    (``cfg.digital()`` from ``readout_digital`` of the analog init,
    ``train_loop`` with ``sgd(0.1)`` and clip 1.0) and the analog
    variants no_carry, carry and carry_pulse_train, each ``steps`` steps
    from the same init (torch.Generator seed 0) on the same batches and
    write-noise seeds.  Reports each variant's mean loss over the last 5
    steps, ``gap_vs_numeric`` and ``gap_closed_by_carry`` as the
    reference computes them, and each variant's median step time.  Gates
    only finite losses."""
    base = tcfg.replace(analog_device="taox:wn64")
    variants = {"no_carry": base,
                "carry": carry_cfg(base, 4, "outer"),
                "carry_pulse_train": carry_cfg(base, 4, "pulse_train")}
    stream = syn.make_token_stream(200_000, base.vocab, seed=0)
    batches = []
    for i in range(steps):
        x, y = syn.batch_tokens(stream, 8, 256, i)
        batches.append({"tokens": torch.from_numpy(x).long().cuda(),
                        "labels": torch.from_numpy(y).long().cuda()})

    def run(step, state, with_rng):
        rng = torch.Generator(device="cuda")
        rng.manual_seed(1)
        losses, walls = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if with_rng:
                state, mets = step(state, batch, rng)
            else:
                state, mets = step(state, batch)
            losses.append(float(mets["loss"]))
            walls.append(time.perf_counter() - t0)
            if not math.isfinite(losses[-1]):
                fail(f"nonideality run: loss {losses[-1]}")
        warm = sorted(walls[1:]) or walls
        return {"loss": losses, "final_loss": float(np.mean(losses[-5:])),
                "median_step_ms": 1e3 * warm[len(warm) // 2]}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dig = base.digital()
    params = M.readout_digital(M.init_params(base, gen, "cuda"), base)
    opt = TO.sgd(0.1)
    numeric = run(TL.make_train_step(dig, opt, clip_norm=1.0),
                  {"params": params, "opt": opt.init(params),
                   "step": torch.zeros((), dtype=torch.int32,
                                       device="cuda"), "err_fb": ()},
                  False)
    del params
    res = {"device": "taox:wn64", "steps": steps, "lr": 0.1,
           "carry_period": 4, "carry_base": 4.0, "numeric": numeric}
    for name, cfg in variants.items():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        reset_launches(K, U)
        res[name] = run(TA.make_analog_sgd_step(cfg, lr=0.1),
                        TA.init_state(gen, cfg, device="cuda"), True)
        res[name]["launches"] = {**K.LAUNCHES, **U.LAUNCHES}
        torch.cuda.empty_cache()
    gap = res["no_carry"]["final_loss"] - numeric["final_loss"]
    res["gap_vs_numeric"] = gap
    res["gap_closed_by_carry"] = (
        (res["no_carry"]["final_loss"] - res["carry"]["final_loss"]) / gap
        if abs(gap) > 1e-9 else None)
    res["reference_cpu_smoke_gap_closed_by_carry"] = 0.85
    report(res)
    closed = res["gap_closed_by_carry"]
    print(f"phase 13(b): write noise x64, {steps} steps: final loss "
          f"(mean of the last 5) numeric {numeric['final_loss']:.4f}, "
          + ", ".join(f"{n} {res[n]['final_loss']:.4f}" for n in variants)
          + f"; gap vs numeric {gap:+.4f}, closed by carry "
          + (f"{closed:.3f}" if closed is not None else "n/a")
          + " (the reference's CPU smoke-size run: 0.85, not a gate); "
          "median step ms: "
          + ", ".join(f"{n} {res[n]['median_step_ms']:.1f}"
                      for n in ("numeric", *variants)))
    return res


# --------------------------------------------------------------------------
# Phase 14: the paper's MLP (784-300-10) trained on the crossbar
# --------------------------------------------------------------------------

#: (mode, device) of phase 14(a); (b) runs ``launch.accuracy``'s six.
MLP_CHECK_RUNS = [("numeric", "taox"), ("analog", "ideal"),
                  ("analog", "taox-nonoise"), ("analog", "taox"),
                  ("pc", "taox")]
#: The accuracies ``benchmarks/accuracy.py`` documents for the full
#: protocol (the reference's own figures; accuracies, not speeds).
MLP_REFERENCE_ACC = {"numeric": 0.990, "analog-ideal": 0.971,
                     "analog-linearized": 0.969, "analog-taox": 0.575,
                     "analog-taox-nonoise": 0.582,
                     "periodic-carry-taox": 0.985}
#: A layer's update on the card against the CPU replay of the same step:
#: the 2-norm of the difference over the 2-norm of the replay's update.
#: The replay takes the card's read results, noise fields and write-driver
#: codes and scales, so only the digital ops and the device model's
#: float32 rounding differ: 2e-6 to 6e-6 on the card, where an update
#: formed from the replay's own codes moved by 0.9-1.1% at one flipped
#: code.  A sample or the bias row left out of an update, or a wrong
#: sign, learning rate or noise field, moves it by several percent or
#: more.
MLP_STEP_BOUND = 1e-4
#: The write drivers' codes (8-bit rows, 4-bit columns) the card forms in
#: one step against those the replay forms from the same operands: an ulp
#: of difference in an activation can put one code across a rounding
#: boundary (one code of 279,200 in a 20-step run on the card), so a code
#: may differ by one level, at most this many codes a step ...
MLP_MAX_CODE_FLIPS = 4
#: ... and a scale (``max|x| / levels``) by a few float32 ulp.
MLP_SCALE_RTOL = 1e-6


def mlp_reads_per_step(mode):
    """(forward, transpose) reads of one training step: the analog MLP
    reads both layers forward and the second transposed (the first
    layer's input is data); pc reads each of its 3 cells."""
    return {"numeric": (0, 0), "analog": (2, 1), "pc": (6, 3)}[mode]


def mlp_expect(mode, steps, evals):
    """Every read-kernel count after ``steps`` training steps (B = 10: the
    FP32 instance, one tile, so no tile-order sum) and ``evals``
    evaluations (B = 2000: the tensor-core instance, dynamic range)."""
    fwd, bwd = mlp_reads_per_step(mode)
    # an evaluation reads what a step reads forward
    return {"fused_vmm": fwd * (steps + evals), "fused_mvm": bwd * steps,
            "read_tile_vmm": fwd * steps, "read_tile_mvm": bwd * steps,
            "read_prepare_vmm": fwd * evals, "read_range_vmm": fwd * evals,
            "tc_read_vmm": fwd * evals}


def mlp_check_counts(K, U, want, what):
    """Every count of the read, write and fakequant kernels since the last
    reset against ``want`` (absent names 0); returns the non-zero ones."""
    got = {**K.LAUNCHES, **U.LAUNCHES}
    want = {**dict.fromkeys(got, 0), **want}
    if got != want:
        fail(f"{what}: launched {got}; expected {want}")
    return {k: v for k, v in got.items() if v}


class RecordingDraws:
    """A trainer's draws (``train.mlp_analog.Draws``) that keeps each one,
    for the CPU replay of the same step."""

    def __init__(self, MLP, seed):
        self.inner = MLP.Draws(seed, "cuda")
        self.kept = {}

    def normal(self, site, shape):
        z = self.inner.normal(site, shape)
        self.kept[site] = z
        return z


class ReplayDraws:
    """The card's draws, site for site, on the CPU."""

    def __init__(self, recording):
        self.recording = recording

    def normal(self, site, shape):
        z = self.recording.kept.pop(site)
        if tuple(z.shape) != tuple(shape):
            fail(f"replayed draw {site} of shape {tuple(z.shape)}")
        return z.cpu()


@contextlib.contextmanager
def replaying_reads(K, results):
    """The plain read returns the card's results, in order."""
    read_plain = K._read_plain
    replay = iter(results)

    def replayed(x, g, ref, sc, cfg, transpose=False):
        y = next(replay, None)
        want = (x.shape[0], x.shape[1], g.shape[1] if transpose
                else g.shape[2])
        if y is None or tuple(y.shape) != want:
            fail(f"the CPU replay read x {tuple(x.shape)} g "
                 f"{tuple(g.shape)} transpose {transpose} with no card "
                 f"read of that shape to replay")
        return y.cpu()

    K._read_plain = replayed
    try:
        yield replay
    finally:
        K._read_plain = read_plain


@contextlib.contextmanager
def recording_codes(XO, kept, given=None):
    """Record the write drivers' codes and scales ``(x_int, x_scale,
    d_int, d_scale)`` of every update the MLP forms
    (``core.xbar_ops.quantize_update_codes``, which the analog layer's
    backward and ``pc_update`` reach through
    ``quantize_update_operands``).  With ``given`` (the card's records of
    the same step), each update writes the card's codes and scales, in
    order, in place of those recorded here."""
    real = XO.quantize_update_codes
    card = iter(given) if given is not None else None

    def recorded(x, d, cfg):
        out = real(x, d, cfg)
        kept.append(tuple(t.detach().cpu() for t in out))
        if card is None:
            return out
        theirs = next(card, None)
        if theirs is None or [t.shape for t in theirs] != [t.shape
                                                           for t in out]:
            fail("the CPU replay formed an update with no card update of "
                 "its shapes to replay")
        return theirs

    XO.quantize_update_codes = recorded
    try:
        yield
    finally:
        XO.quantize_update_codes = real


def code_flips(card, cpu):
    """``(codes that differ, codes compared, largest difference in levels,
    scales that differ, largest relative difference of a scale)`` between
    the write drivers' operands of the card's step and those the CPU
    replay forms from the same operands."""
    if len(card) != len(cpu):
        fail(f"the card formed {len(card)} updates, the replay {len(cpu)}")
    codes = scales = total = 0
    levels = scale_rel = 0.0
    for a, b in zip(card, cpu):
        for i in (0, 2):
            diff = (a[i] - b[i]).abs()
            codes += int((diff != 0).sum())
            total += a[i].numel()
            levels = max(levels, float(diff.max()))
        for i in (1, 3):
            scales += int(not torch.equal(a[i], b[i]))
            scale_rel = max(scale_rel, float((a[i] - b[i]).abs()
                                             / b[i].abs().clamp_min(1e-30)))
    return codes, total, levels, scales, scale_rel


def mlp_layers(params):
    """The trained arrays of an MLP parameter tuple: ``w`` (numeric) or
    ``g`` (a crossbar layer, a pc stack)."""
    return [p["g"] if isinstance(p, dict) else p for p in params]


def phase_mlp_check(K, U, MLP, syn, mode, device, steps, report):
    """Phase 14(a) for one (mode, device): ``steps`` training steps of the
    full-width MLP on the card (the paper's 784-300-10, batch 10, 1024x1024
    tiles, 8-bit DAC/ADC), each replayed on the CPU from the card's
    pre-step parameters with the card's noise fields and read results.

    Gates: each step's counted launches (:func:`mlp_expect`); every read
    of the step against the plain version on the card on its own operands
    (``read_agrees``, the DAC scale bit for bit); the write drivers' codes
    and scales against the replay's (:data:`MLP_MAX_CODE_FLIPS` codes a
    step one level apart, scales within :data:`MLP_SCALE_RTOL`); each
    layer's update, the replay writing the card's codes, within
    :data:`MLP_STEP_BOUND` of the replay's; one evaluation of the
    2000 test digits on the tensor-core instance, its reads checked the
    same way and counted; finite parameters."""
    run = MLP.MLPRun(mode=mode, device=device)
    draws = RecordingDraws(MLP, run.seed)
    card = MLP.MLPTrainer(run, "cuda", draws)
    cpu = MLP.MLPTrainer(run, "cpu", ReplayDraws(draws))
    xtr, ytr = syn.make_digits(run.n_train, seed=run.seed)
    xte, yte = syn.make_digits(run.n_test, seed=run.seed + 1)
    params = card.init()
    cpu.init()                      # consumes the init draws
    worst, n_reads, checked, per_step = 0.0, 0, {}, []
    flips = n_codes = scale_diffs = 0
    worst_level = worst_scale = 0.0
    from repro_torch.core import xbar_ops as XO
    for i in range(steps):
        sl = slice(i * run.batch, (i + 1) * run.batch)
        x, y = torch.from_numpy(xtr[sl]), torch.from_numpy(ytr[sl]).long()
        pre = tree_to(params, "cpu")
        reads, ops_card, ops_cpu = [], [], []
        reset_launches(K, U)
        with recording_reads(K, reads), recording_codes(XO, ops_card):
            params = card.step(params, x.cuda(), y.cuda())
            if mode == "pc" and (i + 1) % run.carry_every == 0:
                params = card.carry(params)
            torch.cuda.synchronize()
        mlp_check_counts(K, U, mlp_expect(mode, 1, 0),
                         f"MLP {mode}/{device} step {i + 1}")
        if reads:
            w = check_reads(K, reads, where="cuda")
            for key, v in w.items():
                checked[key] = max(checked.get(key, 0.0), v)
        n_reads += len(reads)
        with replaying_reads(K, [r[5] for r in reads]) as rest, \
                recording_codes(XO, ops_cpu, ops_card):
            rep = cpu.step(pre, x, y)
            if mode == "pc" and (i + 1) % run.carry_every == 0:
                rep = cpu.carry(rep)
            if next(rest, None) is not None:
                fail(f"MLP {mode}/{device} step {i + 1}: the CPU replay "
                     f"made fewer reads than the card")
        n_diff, n_ops, level, n_sc, sc_rel = code_flips(ops_card, ops_cpu)
        flips += n_diff
        n_codes += n_ops
        scale_diffs += n_sc
        worst_level = max(worst_level, level)
        worst_scale = max(worst_scale, sc_rel)
        if (level > 1 or n_diff > MLP_MAX_CODE_FLIPS
                or sc_rel > MLP_SCALE_RTOL):
            fail(f"MLP {mode}/{device} step {i + 1}: {n_diff} write-driver "
                 f"codes differ from the replay's, by up to {level:g} "
                 f"levels, scales by up to {sc_rel:.3g} (allowed "
                 f"{MLP_MAX_CODE_FLIPS} codes by 1 level, scales "
                 f"{MLP_SCALE_RTOL})")
        per_step.append([n_diff])
        for li, (a, b, p0) in enumerate(zip(mlp_layers(params),
                                            mlp_layers(rep),
                                            mlp_layers(pre)), 1):
            a = a.cpu()
            if not torch.isfinite(a).all():
                fail(f"MLP {mode}/{device} step {i + 1}: layer {li} is "
                     f"not finite")
            move = (b - p0).norm().item()
            rel = (a - b).norm().item() / max(move, 1e-30)
            worst = max(worst, rel)
            per_step[-1].append(rel)
            if rel > MLP_STEP_BOUND:
                fail(f"MLP {mode}/{device} step {i + 1}, layer {li}: the "
                     f"card's update is {rel:.3g} of the replay's off "
                     f"(bound {MLP_STEP_BOUND})")
    # one evaluation of the test set: B = 2000 on the tensor-core instance
    reads = []
    reset_launches(K, U)
    with recording_reads(K, reads):
        acc = card.accuracy(params, torch.from_numpy(xte).cuda(),
                            torch.from_numpy(yte).long().cuda())
        torch.cuda.synchronize()
    mlp_check_counts(K, U, mlp_expect(mode, 0, 1),
                     f"MLP {mode}/{device} evaluation")
    ev = check_reads(K, reads, where="cuda") if reads else {}
    with replaying_reads(K, [r[5] for r in reads]):
        acc_cpu = cpu.accuracy(tree_to(params, "cpu"), torch.from_numpy(xte),
                               torch.from_numpy(yte).long())
    res = {"mode": mode, "device": device, "steps": steps,
           "reads_checked": n_reads, **{f"reads_{k}": v
                                        for k, v in checked.items()},
           "max_update_diff_over_replay_update": worst,
           "per_step_code_flips_and_update_diffs": per_step,
           "write_code_flips": flips, "write_codes_compared": n_codes,
           "write_scales_differing": scale_diffs,
           "max_code_level_diff": worst_level,
           "max_scale_rel_diff": worst_scale,
           "max_code_flips_per_step": MLP_MAX_CODE_FLIPS,
           "bound": MLP_STEP_BOUND, "eval_reads": len(reads),
           **{f"eval_reads_{k}": v for k, v in ev.items()},
           "accuracy_after": float(acc),
           "accuracy_cpu_replay": float(acc_cpu)}
    report(res)
    print(f"  MLP {mode}/{device}: {steps} steps on the card, {n_reads} "
          f"B=10 reads agree with the plain version"
          + (f" (worst {checked['max_err_over_bound']:.3f} of the bound)"
             if checked else "")
          + f"; updates vs the CPU replay at most {worst:.3g} of the "
          f"replay's (bound {MLP_STEP_BOUND}, the replay writing the "
          f"card's codes; {flips} of {n_codes} write-driver codes differ "
          f"by up to {worst_level:g} level, {scale_diffs} scales by up to "
          f"{worst_scale:.3g}); "
          f"evaluation: {len(reads)} "
          f"B=2000 tensor-core reads agree, accuracy {float(acc):.4f} "
          f"(CPU replay {float(acc_cpu):.4f})")
    if abs(float(acc) - float(acc_cpu)) > 1e-3:
        fail(f"MLP {mode}/{device}: evaluation accuracy {float(acc)} on the "
             f"card, {float(acc_cpu)} on the CPU with its reads replayed")
    return res


def profile_mlp_step(K, U, MLP, syn, run, n_steps=50):
    """Device time of one training step of ``run`` on the card, by
    torch.profiler (:func:`device_ms`, corrected per launch), and the
    reads' share of it; the wall time of the same steps unprofiled."""
    trainer = MLP.MLPTrainer(run, "cuda")
    xtr, ytr = syn.make_digits(n_steps * run.batch, seed=run.seed)
    xtr = torch.from_numpy(xtr).cuda()
    ytr = torch.from_numpy(ytr).long().cuda()
    state = {"p": trainer.init()}

    def one(i):
        j = i % n_steps
        sl = slice(j * run.batch, (j + 1) * run.batch)
        state["p"] = trainer.step(state["p"], xtr[sl], ytr[sl])

    one(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        one(i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_steps
    reads = ("fused_read_tile_kernel", "reduce_tiles_kernel",
             "read_prepare_kernel", "tc_range_kernel", "tc_read_kernel")
    got = device_ms(one, n_steps, split=reads)
    if got is None or got[0] is None:
        return {"wall_ms": 1e3 * wall, "device_ms": None}
    ms, parts = got
    read_ms = sum(parts.values())
    return {"wall_ms": 1e3 * wall, "device_ms": ms, "read_ms": read_ms,
            "read_share": read_ms / ms, "idle_share": 1 - ms / (1e3 * wall),
            "read_ms_by_kernel": parts}


def phase_mlp_protocol(K, U, MLP, ACC, syn, report, fast):
    """Phase 14(b): the six runs of ``launch.accuracy`` (Figs. 14 and 15)
    through ``train_mlp`` on the card at the ``MLPRun`` defaults (or
    ``--fast``'s protocol): per-epoch test accuracy, wall seconds (the
    digits' generation included), steps/s, device ms per step and the
    reads' share; the claim lines as ``launch.accuracy`` words them.
    Gates: every run completes with finite accuracies and the counted
    launches of its steps and evaluations (:func:`mlp_expect`); a claim
    that fails is reported, not gated."""
    runs = list(ACC.FIG14_MODES) + [ACC.FIG15]
    results, rows = {}, []
    for name, run in runs:
        if fast:
            run = ACC.fast(run)
        steps = run.epochs * (run.n_train // run.batch)
        reset_launches(K, U)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = MLP.train_mlp(run, log=None, device="cuda")
        wall = time.perf_counter() - t0
        launches = mlp_check_counts(K, U, mlp_expect(run.mode, steps,
                                                     run.epochs),
                                    f"MLP run {name}")
        if not all(math.isfinite(a) for a in out["acc"]):
            fail(f"MLP run {name}: accuracies {out['acc']}")
        prof = profile_mlp_step(K, U, MLP, syn, run)
        row = {"name": name, "mode": run.mode, "device": run.device,
               "epochs": run.epochs, "n_train": run.n_train,
               "n_test": run.n_test, "steps": steps, "acc": out["acc"],
               "final": out["final"],
               "reference_documented_acc": MLP_REFERENCE_ACC[name],
               "wall_s": wall, "steps_per_s": steps / wall,
               "launches": launches, "profile": prof}
        rows.append(row)
        report(row)
        results[name] = out["final"]
        dev = (f"{prof['device_ms']:.3f} ms device per step, reads "
               f"{prof['read_ms']:.3f} ms ({100 * prof['read_share']:.0f}%)"
               if prof.get("device_ms") else "device time not measured")
        print(f"  accuracy/{name}: per epoch "
              f"{'/'.join(f'{a:.4f}' for a in out['acc'])} (the reference "
              f"documents {MLP_REFERENCE_ACC[name]:.3f}); {wall:.1f} s, "
              f"{steps / wall:.0f} steps/s; {dev}, "
              f"{prof['wall_ms']:.3f} ms wall per step")
    claims = ACC.claims(results, carry=True, fast_run=fast)
    for name, ok in claims:
        print(f"claim/{name},0,{'PASS' if ok else 'FAIL'}")
    report({"claims": {n: ok for n, ok in claims}})
    return rows, claims


def read_entry_mlp(K, cfg_of_mlp):
    """Times of the MLP's B = 10 reads (the FP32 instance, one 1024x1024
    tile) against the byte bound, as phase 1 times its reads: layer 1's
    forward (785 x 300), layer 2's forward and transpose (301 x 10)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    out = {}
    for name, k, n, transpose in (("l1_vmm", 785, 300, False),
                                  ("l2_vmm", 301, 10, False),
                                  ("l2_mvm", 301, 10, True)):
        x, g, ref, ws = make_operands(k, n, 10, gen, False, "cuda")
        if transpose:
            x = torch.randn((1, 10, n), generator=gen, device="cuda")
        sc = K.read_scales(x, ws, cfg_of_mlp.adc.in_levels)
        y_k = K._read_cuda(x, g, ref, sc, cfg_of_mlp, transpose)
        torch.cuda.synchronize()
        y_p = K._read_plain(x, g, ref, sc, cfg_of_mlp, transpose)
        ok, err, over, _ = read_agrees(y_k, y_p, x, g, ref, sc, cfg_of_mlp,
                                       transpose)
        if not ok:
            fail(f"MLP read {name} disagrees with its plain version")
        out[name] = {"K": k, "N": n, "B": 10, "transpose": transpose,
                     "instance": K.read_instance(
                         10, cfg_of_mlp.adc.in_levels),
                     "max_abs_err": err, "err_over_bound": over,
                     **time_read(K, x, g, ref, sc, cfg_of_mlp, transpose)}
    return out


def phase_mlp(K, U, MLP, ACC, CMP, syn, report, train, fast=False,
              steps=20):
    """Phase 14: (a) card vs CPU replay per mode, (b) the paper's
    protocol, (c) the port's ``hwmodel`` headline and phase 7's projected
    pJ per MAC.  Returns the figures the kernels line takes."""
    checks = [phase_mlp_check(K, U, MLP, syn, mode, device, steps, report)
              for mode, device in MLP_CHECK_RUNS]
    print(f"phase 14(a): the MLP at full width, {steps} steps of each of "
          f"{len(checks)} runs on the card against the CPU replay: "
          f"{sum(c['reads_checked'] + c['eval_reads'] for c in checks)} "
          f"reads checked, updates within "
          f"{max(c['max_update_diff_over_replay_update'] for c in checks):.3g}"
          f" of the replay's (bound {MLP_STEP_BOUND})")
    reads = read_entry_mlp(K, MLP.MLPRun().crossbar())
    for name, r in reads.items():
        print_read_time(f"MLP {name}", r)
    rows, claims = phase_mlp_protocol(K, U, MLP, ACC, syn, report, fast)
    print(f"phase 14(b): the paper's protocol "
          f"({'--fast' if fast else 'full: 4 epochs, 8000/2000 digits'}), "
          f"{len(rows)} runs complete; claims "
          + ", ".join(f"{n}: {'PASS' if ok else 'FAIL'}" for n, ok in claims))
    head = CMP.headline()
    print(f"phase 14(c): hwmodel headline (the port's copy) "
          + ", ".join(f"{k} {v:.6g}" for k, v in head.items())
          + "; lm100m training step (phase 7) projected pJ per MAC "
          + ", ".join(f"{k} {v:.6g}"
                      for k, v in train["cost"]["pj_per_mac"].items()))
    report({"hwmodel_headline": head,
            "lm100m_step_pj_per_mac": train["cost"]["pj_per_mac"]})
    return {"checks": checks, "reads": reads, "runs": rows,
            "claims": claims}


# --------------------------------------------------------------------------
# Phases 15-17: the registry's dense family, serving maintenance, QAT
# --------------------------------------------------------------------------

#: Phase 15's drift, the reference test's ``DRIFT``.
DRIFT = dict(nu=0.05, nu_sigma=0.5)


def device_serve_cfg(cfg, n_layers=None):
    """Phase 2's serving settings on ``cfg`` (at ``n_layers`` when cut)."""
    cfg = cfg.replace(dtype="float32", analog=True, analog_mode="device",
                      analog_device="taox-nonoise", analog_rows=64,
                      analog_cols=64)
    return cut_depth(cfg, n_layers)


def program_model(M, cfg):
    """Random weights from torch.Generator seed 0, programmed onto
    crossbars under ``cfg``; the digital tree is dropped."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = M.init_params(cfg.digital(), gen, device="cuda")
    aparams = M.program_digital(params, cfg)
    del params
    return aparams


def dense_prompts(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab, rng.integers(8, 17))]
            for _ in range(n)]


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def timed_serve(K, engine, prompts, sp, cfg, what, per_layer=4,
                tc_per_layer=0):
    """One ``generate`` with the read counts set to 0 just before and read
    just after.  Gates: ``per_layer`` reads per layer per model call (4 for
    the dense family, 7 for MoE: its three expert stacks read once each,
    9 with MLA), ``tc_per_layer`` of them on the tensor-core instance with
    its pre-pass and range pass (MLA's ``wkv_b``, which reads the whole
    cache), every other one on the FP32 instance with its K-order sum
    (decode and 16-token prefill chunks; every K spans several 64-row
    tiles), no transpose read, full outputs in the vocabulary."""
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, sp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m = engine.stream.metrics
    calls = m["prefill_chunks"] + m["decode_steps"]
    reads = K.LAUNCHES["fused_vmm"]
    by_kernel = read_kernel_launches([K.LAUNCHES], "vmm")
    n_tok = sum(len(o) for o in outs)
    tc = tc_per_layer * cfg.n_layers * calls
    want = {"fused_read_tile_kernel": reads - tc,
            "reduce_tiles_kernel": reads - tc, "read_prepare_kernel": tc,
            "tc_range_kernel": tc, "tc_read_kernel": tc}
    if reads != per_layer * cfg.n_layers * calls or calls == 0 \
            or by_kernel != want or K.LAUNCHES["fused_mvm"]:
        fail(f"{what}: {reads} reads in {calls} model calls, launches "
             f"{by_kernel}; expected {per_layer * cfg.n_layers} a call, "
             f"each {want}")
    if [len(o) for o in outs] != [sp.max_new_tokens] * len(prompts) or \
            not all(0 <= t < cfg.vocab for o in outs for t in o):
        fail(f"{what}: bad outputs {outs}")
    return outs, {"tokens": n_tok, "seconds": dt, "tokens_per_s": n_tok / dt,
                  "model_calls": calls, "reads": reads,
                  "launches_by_kernel": by_kernel}


def probe_reads(K, M, params, cfg, prompt):
    """A prefill of ``prompt`` and one decode step, every read recorded
    and held against the plain version on the card on its own operands
    (phase 1's bound); returns (prefill logits, worst figures)."""
    reads = []
    toks = torch.tensor([prompt], device="cuda")
    with torch.no_grad(), recording_reads(K, reads):
        logits, cache = M.prefill(params, {"tokens": toks}, cfg, 64)
        M.decode_step(params, cache, logits.argmax(-1), cfg)
    torch.cuda.synchronize()
    if len(reads) != 8 * cfg.n_layers:
        fail(f"{cfg.name}: {len(reads)} reads in a prefill and a decode "
             f"step; expected {8 * cfg.n_layers}")
    worst = check_reads(K, reads, where="cuda")
    worst["reads_checked"] = len(reads)
    return logits, worst


def prefill_logits(M, params, cfg, prompt):
    with torch.no_grad():
        return M.prefill(params, {"tokens": torch.tensor(
            [prompt], device="cuda")}, cfg, 64)[0]


def phase_gemma(M, K, E, make_engine, SamplingParams, get_config, report):
    """gemma-2b at full size (all 18 layers, full widths) served from
    programmed crossbars with maintenance (see the module docstring)."""
    cfg = device_serve_cfg(get_config("gemma-2b"))
    spec = E.RetentionSpec(**DRIFT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine(cfg, program_model(M, cfg), backend="analog",
                         n_slots=4, prefill_chunk=16, max_len=64,
                         retention=spec)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    st, rt = engine.state, engine.maintenance
    cells = sum(st.g_target[p]["g"].numel() for p in st.paths)
    resident_gb = torch.cuda.memory_allocated() / 1e9
    print(f"phase 15: gemma-2b programmed at full size in {program_s:.1f} s: "
          f"{len(st.paths)} containers, {cells / 1e9:.3f} B cells, "
          f"{resident_gb:.2f} GB resident (g, ref, g_target, embedding)")
    prompts = dense_prompts(cfg, 4)
    sp = SamplingParams(max_new_tokens=32)
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))  # warm-up
    base, serve1 = timed_serve(K, engine, prompts, sp, cfg, "gemma-2b serve")
    logits0, worst = probe_reads(K, M, engine.params, cfg, prompts[0])
    profile = profile_decode_step(M, cfg, engine.params, "crossbar",
                                  ("fused_read_tile", "reduce_tiles"))

    # drift: 3 days, applied by the next tick (timed alone here)
    path = ("layers", "attn", "wo")
    n_reads = st.reads_unapplied[path]
    engine.advance_clock(3 * 86400.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_maintenance()
    torch.cuda.synchronize()
    drift_ms = 1e3 * (time.perf_counter() - t0)
    drift_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # layer 0 of wo drifted on the CPU from its programming targets: the
    # runtime's block 0 (cells 0 .. K N - 1 of the container's fields)
    target = st.g_target[path]
    want = E.apply_retention(target["g"][0].cpu(), target["ref"][0].cpu(),
                             0.0, 3 * 86400.0, torch.tensor(float(n_reads)),
                             spec, salt=zlib.crc32("/".join(path).encode()))
    live = tree_get(engine.params, path)
    drift_rel = max(((live[k][0].cpu() - w).abs()
                     / w.abs().clamp(min=1e-30)).max().item()
                    for k, w in zip(("g", "ref"), want))
    if not drift_rel <= 1e-6:
        fail(f"gemma-2b: the card's drifted {path} layer 0 is "
             f"{drift_rel:.3g} relative off the CPU's (bound 1e-6)")
    drifted, serve2 = timed_serve(K, engine, prompts, sp, cfg,
                                  "gemma-2b drifted serve")
    logit_shift = (prefill_logits(M, engine.params, cfg, prompts[0])
                   - logits0).abs().max().item()
    if drifted == base and logit_shift == 0.0:
        fail("gemma-2b: 3 days of drift changed neither tokens nor logits")

    # recalibration, drained through serving ticks while a request decodes
    sweep_ms = []
    recal_one = rt._recal_one

    def timed_recal(p):
        torch.cuda.synchronize()
        t = time.perf_counter()
        recal_one(p)
        torch.cuda.synchronize()
        sweep_ms.append(1e3 * (time.perf_counter() - t))
    rt._recal_one = timed_recal
    stream = engine.stream
    engine.reset(0)                       # counts from 0 for this drain
    try:
        rid = engine.submit(prompts[1], SamplingParams(max_new_tokens=16))
        while not stream.metrics["decode_steps"]:
            engine.step()
        decode0 = stream.metrics["decode_steps"]
        engine.start_recalibration()
        ticks = 0
        while engine.has_work():
            engine.step()
            ticks += 1
    finally:
        del rt._recal_one         # the class's method again: no cycle
    recal_ticks = stream.metrics["recal_ticks"]
    if recal_ticks != len(st.paths) or rt.recal_pending \
            or stream.metrics["decode_steps"] - decode0 != ticks \
            or len(stream.completed[rid]) != 16:
        fail(f"gemma-2b recalibration: {recal_ticks} recal ticks for "
             f"{len(st.paths)} containers, {ticks} ticks, decode steps "
             f"{stream.metrics['decode_steps'] - decode0}")
    for p in st.paths:
        cont = tree_get(engine.params, p)
        if not all(torch.equal(cont[k], st.g_target[p][k])
                   for k in ("g", "ref")):
            fail(f"gemma-2b: {p} not restored to g_target bit for bit")
        if not st.pulses[p] > 0 or st.age_s[p] != 0.0:
            fail(f"gemma-2b: {p} pulses {st.pulses[p]}, age {st.age_s[p]}")
    restored, serve3 = timed_serve(K, engine, prompts, sp, cfg,
                                   "gemma-2b restored serve")
    if restored != base:
        fail(f"gemma-2b: tokens after recalibration {restored} differ from "
             f"the first serve's {base}")
    restored_diff = (prefill_logits(M, engine.params, cfg, prompts[0])
                     - logits0).abs().max().item()
    energy = engine.energy_per_token()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = {"config": "gemma-2b, 18 layers, full widths", "cells": cells,
           "program_s": program_s, "resident_gb": resident_gb,
           "serves": {"first": serve1, "drifted": serve2,
                      "restored": serve3},
           "probe_reads": worst, "decode_profile": profile,
           "drift_ms": drift_ms, "drift_peak_gb": drift_peak_gb,
           "drift_block_rel_err_vs_cpu": drift_rel,
           "drift_tokens_changed": drifted != base,
           "drift_logit_shift": logit_shift,
           "sweep_ms_per_container": sweep_ms, "sweep_ms": sum(sweep_ms),
           "recal_ticks": recal_ticks,
           "pulses": {"/".join(p): st.pulses[p] for p in st.paths},
           "maintenance": dict(rt.metrics),
           "restored_logit_diff": restored_diff,
           "peak_memory_gb": peak_gb, "energy_per_token": energy}
    report(res)
    print(f"phase 15: gemma-2b serves {serve1['tokens_per_s']:.1f}, drifted "
          f"{serve2['tokens_per_s']:.1f}, restored "
          f"{serve3['tokens_per_s']:.1f} tokens/s; decode step device "
          f"{profile['device_ms']:.2f} ms of {profile['wall_ms']:.2f} wall; "
          f"{worst['reads_checked']} probe reads agree "
          f"({worst['max_err_over_bound']:.3f} of the bound); drift "
          f"{drift_ms:.1f} ms (layer 0 of wo vs CPU {drift_rel:.3g} rel), "
          f"tokens changed {drifted != base}, logits moved "
          f"{logit_shift:.3g}; sweep {sum(sweep_ms):.1f} ms over "
          f"{recal_ticks} ticks, {rt.metrics['recal_pulses']:.4g} pulses; "
          f"tokens restored exactly (logits {restored_diff:.3g}); peak "
          f"{peak_gb:.2f} GB; energy/token analog "
          f"{energy['analog_pj']:.4g} pJ, digital ReRAM "
          f"{energy['digital_reram_pj']:.4g}, SRAM {energy['sram_pj']:.4g}")
    return res


def phase_dense_serve(M, K, make_engine, SamplingParams, get_config, name,
                      n_layers, report):
    """Phase 16: ``name`` at full width cut to ``n_layers`` layers, served
    with phase 15's settings (8 new tokens); every read of one prefill
    and one decode call against its plain version on its own operands."""
    full = get_config(name)
    cfg = device_serve_cfg(full, n_layers)
    torch.cuda.reset_peak_memory_stats()
    engine = make_engine(cfg, program_model(M, cfg), backend="analog",
                         n_slots=4, prefill_chunk=16, max_len=64)
    prompts = dense_prompts(cfg, 4, seed=1)
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))
    _, serve = timed_serve(K, engine, prompts,
                           SamplingParams(max_new_tokens=8), cfg,
                           f"{name} serve")
    _, worst = probe_reads(K, M, engine.params, cfg, prompts[0])
    res = {"config": name, "cut": f"{n_layers} of {full.n_layers} layers, "
           "full widths", **serve, "probe_reads": worst,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    report(res)
    print(f"phase 16: {name} ({res['cut']}) served "
          f"{serve['tokens_per_s']:.1f} tokens/s, {serve['reads']} reads; "
          f"{worst['reads_checked']} probe reads agree "
          f"({worst['max_err_over_bound']:.3f} of the bound); peak "
          f"{res['peak_memory_gb']:.2f} GB")
    return res


def phase_dense_train(K, U, TA, syn, get_config, report):
    """Phase 16: one device-mode training step of starcoder2-3b (full
    widths, 2 of 30 layers), 8 x 256 tokens, TaOx, lr 0.1; every launch
    against its plain version on its own operands (phase 7's classes)."""
    full = get_config("starcoder2-3b")
    cfg = full.replace(dtype="float32", analog=True, analog_mode="device",
                       analog_device="taox", analog_rows=64, analog_cols=64,
                       n_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    state = TA.init_state(gen, cfg, device="cuda")
    step = TA.make_analog_sgd_step(cfg, lr=0.1)
    stream = syn.make_token_stream(200_000, cfg.vocab, seed=0)
    x, y = syn.batch_tokens(stream, 8, 256, 0)
    batch = {"tokens": torch.from_numpy(x).long().cuda(),
             "labels": torch.from_numpy(y).long().cuda()}
    expect = tensor_core_train_expect(
        cfg.n_layers, fakequant=0, **dict.fromkeys(FQ_KERNELS.values(), 0),
        outer_update=4, pulse_update=0, update_tc=4, update_prepare=4,
        update_fp32=0)
    reads, writes = [], []
    update_cuda = U._update_cuda
    U._update_cuda = recording_writes(U, writes)
    reset_launches(K, U)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with recording_reads(K, reads):
            state, mets = step(state, batch, 12345)
            torch.cuda.synchronize()
    finally:
        U._update_cuda = update_cuda
    step_ms = 1e3 * (time.perf_counter() - t0)
    got = {**K.LAUNCHES, **U.LAUNCHES}
    if got != expect:
        fail(f"starcoder2-3b train step launched {got}; expected {expect}")
    loss = float(mets["loss"])
    if not math.isfinite(loss):
        fail(f"starcoder2-3b train step: loss {loss}")
    worst, upd = check_step1(K, U, reads, writes)
    for path, g in tree_leaves(state["params"]):
        if path[-1] == "g" and not (g.min() >= 0 and g.max() <= 1):
            fail(f"starcoder2-3b: conductances of {path} left the window")
    res = {"config": "starcoder2-3b", "cut": "2 of 30 layers, full widths",
           "loss": loss, "step_ms_recorded": step_ms, "launches": got,
           "reads_checked": len(reads), "writes_checked": len(writes),
           **{f"reads_{k}": v for k, v in worst.items()},
           **{f"writes_{k}": v for k, v in upd.items()},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    report(res)
    print(f"phase 16: starcoder2-3b ({res['cut']}) one device-mode step, "
          f"8 x 256 tokens: loss {loss:.5f}, launches {got}; {len(reads)} "
          f"reads ({worst['max_err_over_bound']:.3f} of the bound) and "
          f"{len(writes)} writes ({upd['max_err_over_twin_bound']:.3f} of "
          f"the twin's bound) agree with their plain versions; peak "
          f"{res['peak_memory_gb']:.2f} GB")
    return res


@contextlib.contextmanager
def counting_fq_paths(K, OPS, calls):
    """Count the fakequant plain expressions a QAT step runs: the kernel's
    plain version, and the projection's eager expression outside (a
    forward) and inside (the backward's recomputation) ``_fakequant_vjp``."""
    plain, eager, vjp = (K._fakequant_plain, OPS._fakequant_eager,
                         OPS._fakequant_vjp)
    inside = []

    def count_plain(*args):
        calls["kernel plain version"] += 1
        return plain(*args)

    def count_eager(*args):
        calls["backward recompute" if inside else "plain forward"] += 1
        return eager(*args)

    def count_vjp(*args):
        inside.append(1)
        try:
            return vjp(*args)
        finally:
            inside.pop()
    K._fakequant_plain, OPS._fakequant_eager, OPS._fakequant_vjp = (
        count_plain, count_eager, count_vjp)
    try:
        yield
    finally:
        K._fakequant_plain, OPS._fakequant_eager, OPS._fakequant_vjp = (
            plain, eager, vjp)


@contextlib.contextmanager
def recording_lsbs(OPS, lsbs):
    """Record every output-ADC range the fakequant eager expression forms
    (``kernels.ops._adc_lsb``: ``(sat, lsb, out_levels)``); in a QAT step
    on the card only the backward's recomputation forms them."""
    adc_lsb = OPS._adc_lsb

    def recorded(q, adc, *args):
        sat, lsb = adc_lsb(q, adc, *args)
        lsbs.append((sat.detach().clone(), lsb.detach().clone(),
                     adc.out_levels))
        return sat, lsb
    OPS._adc_lsb = recorded
    try:
        yield
    finally:
        OPS._adc_lsb = adc_lsb


def lsb_division_ok(sat, lsb, out_levels):
    """The recomputed ADC lsb equals the float32 division ``sat /
    out_levels`` bit for bit (numpy's IEEE division on the host), as
    :func:`dac_scale_ok` holds the DAC scale."""
    want = sat.cpu().numpy() / np.float32(out_levels)
    return bool(np.array_equal(lsb.cpu().numpy(), want))


def loss_grads(M, TO, params, batch, cfg):
    """The loss and its gradient per leaf path."""
    leaves = TO.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = M.loss_fn(leaves, batch, cfg)
    loss.backward()
    return loss.detach(), dict(tree_leaves(TO.tree_map(lambda p: p.grad,
                                                       leaves)))


def phase_qat(K, OPS, M, TL, TO, syn, get_config, report):
    """Phase 17: lm100m at full width in fakequant mode (1024-row tiles,
    8-bit), 4 steps of ``make_train_step(cfg, adamw(3e-4))`` on 8 x 256
    tokens (see the module docstring)."""
    cfg = get_config("lm100m").replace(dtype="float32", analog=True,
                                       analog_mode="fakequant")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    state = TL.init_state(gen, cfg, TO.adamw(3e-4), device="cuda")
    step = TL.make_train_step(cfg, TO.adamw(3e-4))
    stream = syn.make_token_stream(200_000, cfg.vocab, seed=0)
    per = 4 * cfg.n_layers
    want = {"fakequant_scale_kernel": 0, "fakequant_prepare_kernel": per,
            "fakequant_fp32_kernel": 0, "fakequant_tc_kernel": per,
            "fakequant_epilogue_kernel": per}

    def batch_of(i):
        x, y = syn.batch_tokens(stream, 8, 256, i)
        return {"tokens": torch.from_numpy(x).long().cuda(),
                "labels": torch.from_numpy(y).long().cuda()}

    # the gradient at step 1's state: kernel forward vs all-eager forward
    batch = batch_of(0)
    reads = []
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    lsbs = []
    with recording_fq(K, reads), recording_lsbs(OPS, lsbs):
        loss_k, grads_k = loss_grads(M, TO, state["params"], batch, cfg)
    torch.cuda.synchronize()
    if K.LAUNCHES["fakequant"] != per or len(reads) != per:
        fail(f"QAT gradient pass made {K.LAUNCHES['fakequant']} fakequant "
             f"reads; expected {per}")
    # the backward's recomputed ADC lsb: the float32 division, bit for bit
    if len(lsbs) != per or not all(lsb.is_cuda for _, lsb, _ in lsbs):
        fail(f"the QAT backward formed {len(lsbs)} ADC ranges on the card; "
             f"expected {per}")
    lsb_values = sum(lsb.numel() for _, lsb, _ in lsbs)
    for sat, lsb, levels in lsbs:
        if not lsb_division_ok(sat, lsb, levels):
            fail("the QAT backward's recomputed ADC lsb differs from the "
                 "float32 division sat / out_levels")
    del lsbs
    resolve, eager = OPS.resolve_impl, OPS._fakequant_eager
    replay = iter([r[5] for r in reads])

    def replayed(x, w, adc, rows):
        """The eager expression's graph carrying the kernel's value."""
        y = eager(x, w, adc, rows)
        return y + (next(replay).reshape(y.shape) - y).detach()
    OPS.resolve_impl = lambda impl, x: "eager"
    try:
        loss_e, grads_e = loss_grads(M, TO, state["params"], batch, cfg)
        OPS._fakequant_eager = replayed
        loss_r, grads_r = loss_grads(M, TO, state["params"], batch, cfg)
    finally:
        OPS.resolve_impl, OPS._fakequant_eager = resolve, eager
    if next(replay, None) is not None:
        fail("the replayed eager pass made fewer fakequant reads")

    def rel(grads):
        return {"/".join(p): ((grads_k[p] - g).norm()
                              / g.norm().clamp(min=1e-30)).item()
                for p, g in grads.items()}
    grad_rel, free_rel = rel(grads_r), rel(grads_e)
    flips, worst_fq = 0, 0.0
    with torch.no_grad():
        for x, w, sc, adc, rows, y in reads:
            y_e = eager(x, w, adc, rows)
            flips += int(((y - y_e).abs() > 1e-5 * y_e.abs().amax()).sum())
            ok, _, over, _ = fq_agrees(y, K._fakequant_plain(x, w, sc, adc,
                                                             rows),
                                       x, w, sc, adc, rows)
            worst_fq = max(worst_fq, over)
            if not ok:
                fail(f"a QAT fakequant read disagrees with the plain "
                     f"version on its operands: x {tuple(x.shape)} w "
                     f"{tuple(w.shape)}, {over} of the bound")
    del reads, grads_k, grads_e, grads_r
    worst = max(grad_rel.values())
    if not worst <= 1e-4:
        fail(f"QAT gradient, kernel forward vs the eager graph carrying the "
             f"kernel's values: {grad_rel} (bound 1e-4 relative in 2-norm "
             f"per leaf)")

    losses, step_ms, launches, calls = [], [], [], []
    for i in range(4):
        b = batch if i == 0 else batch_of(i)
        for name in K.LAUNCHES:
            K.LAUNCHES[name] = 0
        count = collections.Counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting_fq_paths(K, OPS, count):
            state, mets = step(state, b)
            torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        got = {name: K.LAUNCHES[c] for name, c in FQ_KERNELS.items()}
        launches.append(got)
        calls.append(dict(count))
        losses.append(float(mets["loss"]))
        print(f"  QAT step {i + 1}: loss {losses[-1]:.5f}, "
              f"{step_ms[-1]:.1f} ms, launches {got}, plain expressions "
              f"{dict(count)}")
        if got != want or K.LAUNCHES["fakequant"] != per:
            fail(f"QAT step {i + 1} launched {got}; expected {want}")
        if count["plain forward"] or count["kernel plain version"] \
                or count["backward recompute"] != per:
            fail(f"QAT step {i + 1} ran plain expressions {dict(count)}; "
                 f"expected only {per} backward recomputations")
        if not math.isfinite(losses[-1]):
            fail(f"QAT step {i + 1}: loss {losses[-1]}")
    warm = step_ms[1:]
    res = {"config": "lm100m, fakequant, 1024-row tiles, 8-bit",
           "losses": losses, "step_ms": step_ms,
           "ms_per_step": sum(warm) / len(warm),
           "tokens_per_s": 2048 / (sum(warm) / len(warm) / 1e3),
           "launches_per_step": launches, "plain_calls_per_step": calls,
           "grad_rel_err_vs_replayed_eager": grad_rel,
           "grad_rel_err_max": worst,
           "grad_rel_err_vs_free_eager": free_rel,
           "loss_kernel_vs_eager": abs(float(loss_k) - float(loss_e)),
           "loss_kernel_vs_replayed_eager": abs(float(loss_k)
                                                - float(loss_r)),
           "code_flips": flips, "reads_max_err_over_bound": worst_fq,
           "backward_lsbs_bit_equal": lsb_values,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    report(res)
    print(f"phase 17: QAT, lm100m at full width, 4 steps of 8 x 256 tokens "
          f"through make_train_step(adamw(3e-4)): losses "
          f"{[round(v, 5) for v in losses]}, {res['ms_per_step']:.1f} ms per "
          f"warm step ({res['tokens_per_s']:.0f} tokens/s), {per} "
          f"tensor-core fakequant reads a step ({worst_fq:.3f} of the "
          f"read bound at most); gradient vs the eager graph carrying the "
          f"kernel's values {worst:.3g} relative at most; vs the free "
          f"eager forward {max(free_rel.values()):.3g} ({flips} code flips "
          f"between the two forwards); the backward's {lsb_values} ADC "
          f"lsbs equal the float32 division; peak "
          f"{res['peak_memory_gb']:.2f} GB")
    return res


# --------------------------------------------------------------------------
# Phase 18: the MoE family (llama4-scout-17b-a16e) at full width
# --------------------------------------------------------------------------

MOE_ARCH = "llama4-scout-17b-a16e"
#: Crossbar reads a MoE layer makes per model call: wqkv, wo, the shared
#: expert's w_upgate and w_down, and one read of each expert stack.
MOE_READS = 7
#: The training step's depth: two full-width layers need 35 GB of g + ref,
#: 8.3 GB of embedding and head, their 8.3 GB of gradients and 8.3 GB of
#: updated copies, and the new conductances of every container (17.6 GB)
#: before the write's transients: more than the card's 80 GB.
MOE_TRAIN_LAYERS = 1


def moe_reads(cfg):
    """Crossbar (or fakequant) reads of one MoE layer per model call:
    ``MOE_READS``, or ``MLA_READS`` with MLA attention."""
    return MLA_READS if cfg.use_mla else MOE_READS


@contextlib.contextmanager
def recording_routes(TMoE, routes):
    """Record every routing decision of the MoE layers: ``(probs, top_p,
    top_i)`` per call of ``models.moe.route``."""
    route = TMoE.route

    def recorded(p, xt, cfg, seq=0):
        out = route(p, xt, cfg, seq)
        routes.append(tuple(t.detach().clone() for t in out))
        return out

    TMoE.route = recorded
    try:
        yield
    finally:
        TMoE.route = route


def dropped_tokens(routes, cfg):
    """Routed (token, expert) pairs past their expert's capacity, summed
    over the recorded routing calls."""
    from repro_torch.core.analog_registry import expert_capacity
    out = 0
    for _, _, top_i in routes:
        cap = expert_capacity(top_i.shape[0], cfg)
        counts = torch.bincount(top_i.reshape(-1), minlength=cfg.n_experts)
        out += int(torch.clamp(counts - cap, min=0).sum())
    return out


def meta_containers(params, meta=lambda path: path[-1] in ("g", "ref"),
                    path=()):
    """A CPU copy of a tree whose leaves at the paths ``meta`` picks are
    shapes only (meta tensors): by default a device-mode tree's
    conductances (``g``, ``ref``); for a fakequant tree,
    :func:`crossbar_leaf`'s projection weights.  The replayed CPU run
    never reads them."""
    if isinstance(params, dict):
        return {k: meta_containers(v, meta, path + (k,))
                for k, v in params.items()}
    return params.to("meta") if meta(path) else params.cpu()


def moe_replay_cpu(M, TT, TMoE, cfg, cpu_params, toks, reads, routes,
                   run=None, OPS=None):
    """Logits on the CPU with the card's read results (``reads``) and
    routing choices (``routes``) replayed: by default the prefill of
    ``toks``, else ``run(cpu_params)``; crossbar reads replace
    ``core.tiled_analog.vmm``, or with ``OPS`` (``kernels.ops``) fakequant
    reads replace its eager expression.  Returns the logits and how many
    (token, k) routing choices of the CPU's own router differed from the
    card's."""
    read_it, route_it = iter(reads), iter(routes)
    flips = [0]
    route = TMoE.route

    def replay_read(x, g, ref, w_scale, xcfg, **_):
        y = next(read_it)[5]
        want = (*x.shape[:-1], g.shape[-1])
        return y.cpu().reshape(want)

    def replay_fq(x, w, adc, rows):
        return next(read_it)[5].cpu().reshape(*x.shape[:-1], w.shape[-1])

    def replay_route(p, xt, c, seq=0):
        probs, _, top_i = route(p, xt, c, seq)
        card_i = next(route_it)[2].cpu()
        flips[0] += int((card_i != top_i).sum())
        top_p = torch.gather(probs, 1, card_i)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        return probs, top_p, card_i

    if run is None:
        def run(p):
            return M.prefill(p, {"tokens": toks.cpu()}, cfg, 64)[0]
    vmm, TMoE.route = TT.vmm, replay_route
    eager = OPS._fakequant_eager if OPS is not None else None
    if OPS is not None:
        OPS._fakequant_eager = replay_fq
    else:
        TT.vmm = replay_read
    try:
        with torch.no_grad():
            logits = run(cpu_params)
    finally:
        TT.vmm, TMoE.route = vmm, route
        if OPS is not None:
            OPS._fakequant_eager = eager
    if next(read_it, None) is not None or next(route_it, None) is not None:
        fail("the CPU replay made fewer reads or routing calls than the "
             "card")
    return logits, flips[0]


def expert_read_ms(K, M, cfg, params, n_experts, max_len=32):
    """CUDA-event time of the expert-stack reads of one decode step
    (``decode_read_spans`` over the reads of an ``n_experts`` lead dim),
    and their g + ref bytes against the HBM rate."""
    spans = decode_read_spans(K, M, cfg, params, {}, max_len,
                              lead=n_experts).values()
    n_bytes = sum(d["bytes"] for d in spans)
    return {"expert_reads": sum(d["reads"] for d in spans),
            "expert_read_ms": sum(d["ms"] for d in spans),
            "expert_read_bytes": n_bytes,
            "expert_read_bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S}


def phase_moe_serve(M, K, TT, TMoE, make_engine, SamplingParams, get_config,
                    report):
    """Phase 18(a): llama4-scout at full width, 2 layers, served from
    expert-batched crossbars (see the module docstring)."""
    torch.cuda.empty_cache()   # the earlier phases' cached blocks
    full = get_config(MOE_ARCH)
    cfg = device_serve_cfg(full, 2)
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine(cfg, program_model(M, cfg), backend="analog",
                         n_slots=4, prefill_chunk=16, max_len=64)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    params = engine.params
    resident_gb = torch.cuda.memory_allocated() / 1e9
    ex = params["layers"]["moe"]["experts"]["w_up"]
    want = (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    if tuple(ex["g"].shape) != want \
            or tuple(ex["w_scale"].shape) != want[:2]:
        fail(f"llama4-scout expert container {tuple(ex['g'].shape)}, "
             f"w_scale {tuple(ex['w_scale'].shape)}")
    cells = sum(v.numel() for path, v in tree_leaves(params)
                if path[-1] == "g")
    print(f"phase 18: llama4-scout (2 of 48 layers, full widths) programmed "
          f"in {program_s:.1f} s: {cells / 1e9:.3f} B cells in g, "
          f"{resident_gb:.2f} GB resident ({start_gb:.2f} GB allocated "
          "before)")
    prompts = dense_prompts(cfg, 4)
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))
    routes = []
    with recording_routes(TMoE, routes):
        outs, serve = timed_serve(K, engine, prompts,
                                  SamplingParams(max_new_tokens=16), cfg,
                                  "llama4-scout serve", per_layer=MOE_READS)
    serve["dropped_pairs"] = dropped_tokens(routes, cfg)
    # a prefill and a decode call, every read held on its own operands
    reads, routes = [], []
    toks = torch.tensor([prompts[0]], device="cuda")
    with torch.no_grad(), recording_reads(K, reads), \
            recording_routes(TMoE, routes):
        logits, cache = M.prefill(params, {"tokens": toks}, cfg, 64)
        M.decode_step(params, cache, logits.argmax(-1), cfg)
    torch.cuda.synchronize()
    if len(reads) != 2 * MOE_READS * cfg.n_layers:
        fail(f"llama4-scout: {len(reads)} reads in a prefill and a decode "
             f"step; expected {2 * MOE_READS * cfg.n_layers}")
    worst = check_reads(K, reads, where="cuda")
    worst["reads_checked"] = len(reads)
    if worst["zero_leads"] < 1:
        fail("llama4-scout: no expert read an all-zero buffer")
    # the prefill's logits on the CPU, reads and routing replayed
    n_prefill = MOE_READS * cfg.n_layers
    cpu_params = meta_containers(params)
    cpu_logits, route_flips = moe_replay_cpu(
        M, TT, TMoE, cfg, cpu_params, toks, reads[:n_prefill],
        routes[:cfg.n_layers])
    del cpu_params
    replay_diff = (logits.cpu() - cpu_logits).abs().max().item()
    if not replay_diff <= 1e-3:
        fail(f"llama4-scout: card and CPU prefill logits differ by "
             f"{replay_diff} with the reads and routing replayed")
    profile = profile_decode_step(M, cfg, params, "crossbar",
                                  ("fused_read_tile", "reduce_tiles"))
    profile.update(expert_read_ms(K, M, cfg, params, cfg.n_experts))
    if profile.get("device_ms"):
        profile["expert_read_share"] = \
            profile["expert_read_ms"] / profile["device_ms"]
    energy = engine.energy_per_token()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = {"config": MOE_ARCH, "cut": "2 of 48 layers, full widths",
           "cells": cells, "program_s": program_s,
           "resident_gb": resident_gb, "allocated_before_gb": start_gb,
           "serve": serve, "probe_reads": worst,
           "replay_max_abs_logit_diff": replay_diff,
           "max_abs_logit": logits.abs().max().item(),
           "route_choices_differing_on_cpu": route_flips,
           "decode_profile": profile, "peak_memory_gb": peak_gb,
           "energy_per_token": energy}
    report(res)
    print(f"phase 18(a): llama4-scout served {serve['tokens_per_s']:.1f} "
          f"tokens/s from crossbars ({serve['reads']} reads in "
          f"{serve['model_calls']} calls, {serve['dropped_pairs']} routed "
          f"pairs dropped by capacity); {worst['reads_checked']} probe "
          f"reads agree ({worst['max_err_over_bound']:.3f} of the bound, "
          f"{worst['zero_leads']} all-zero experts read exact zeros); "
          f"replayed CPU logits {replay_diff:.3g} off, {route_flips} "
          f"routing choices differ on the CPU; decode step device "
          f"{profile.get('device_ms', 0):.2f} ms, expert reads "
          f"{profile['expert_read_ms']:.2f} ms for "
          f"{profile['expert_read_bytes'] / 1e9:.1f} GB (bound "
          f"{profile['expert_read_bound_ms']:.2f} ms); peak {peak_gb:.2f} GB")
    del engine, params
    return res


def fq_lead_case(K, name, e, t, k, n, rows, cls, gen, adc, instance,
                 zero=(), timed=False):
    """One expert-stack fakequant read (x (E, T, K) through w (E, K, N))
    on the card against the plain version per expert on the card: the
    exact class bit-equal, the float class within ``fq_agrees`` per
    expert; every expert's DAC scale equal to ``fakequant_scale``; the
    experts in ``zero`` read all-zero buffers and give exact zeros."""
    if cls == "exact":
        pairs = [fq_exact_operands(t, k, n, gen) for _ in range(e)]
        x = torch.stack([a for a, _ in pairs])
        w = torch.stack([b for _, b in pairs])
    else:
        x = torch.randn((e, t, k), generator=gen, device="cuda")
        x *= torch.logspace(-3, 2, e, device="cuda")[:, None, None]
        w = torch.randn((e, k, n), generator=gen, device="cuda") \
            / math.sqrt(k)
    for i in zero:
        x[i] = 0.0
    launches = dict(K.LAUNCHES)
    y_k, sc_k = K._fakequant_cuda(x, w, adc, rows, instance)
    torch.cuda.synchronize()
    got = {c: K.LAUNCHES[c] - launches[c] for c in K.LAUNCHES}
    per_read = {"fakequant": 1, "fakequant_lead": 1, "fakequant_epilogue": 1,
                "fakequant_scale" if instance == "fp32"
                else "fakequant_prepare": 1,
                "fakequant_fp32" if instance == "fp32"
                else "fakequant_tc": 1}
    if {c: v for c, v in got.items() if v} != per_read:
        fail(f"fakequant {name}: one stack read launched {got}")
    sc = K.fakequant_scale(x, adc.in_levels)
    if not torch.equal(sc_k, sc):
        fail(f"fakequant {name}: the pre-pass's scales differ from "
             "fakequant_scale")
    twin = K._fakequant_tc_plain if instance == "tensor_core" else None
    row = {"case": name, "E": e, "T": t, "K": k, "N": n, "rows": rows,
           "class": cls, "instance": instance, "max_abs_err": 0.0,
           "max_err_over_bound": 0.0, "zero_experts": len(zero)}
    for i in range(e):
        y_p = K._fakequant_plain(x[i], w[i], sc[i:i + 1], adc, rows)
        if i in zero:
            ok = not y_k[i].any() and not y_p.any()
            err = over = 0.0
        elif cls == "exact":
            ok = torch.equal(y_k[i], y_p) and (
                twin is None or torch.equal(
                    y_k[i], twin(x[i], w[i], sc[i:i + 1], adc, rows)))
            err = over = (y_k[i] - y_p).abs().max().item()
        else:
            ok, err, over, _ = fq_agrees(y_k[i], y_p, x[i], w[i],
                                         sc[i:i + 1], adc, rows)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["max_err_over_bound"] = max(row["max_err_over_bound"], over)
        if not ok:
            fail(f"fakequant {name}: expert {i} disagrees with the plain "
                 f"version (err {err}, {over} of the bound)")
    if timed:
        row.update(time_fq_lead(K, x, w, sc, adc, rows, instance))
    return row


def time_fq_lead(K, x, w, sc, adc, rows, instance):
    """CUDA-event times of the expert-stack read (whole), its plain
    version (the per-expert loop) and the bounds: the bytes (x, W read
    once, y written once) at the HBM rate, 2 E T K N flops at the FP32
    rate, and the tensor-core floor."""
    e, t, k = x.shape
    n = w.shape[2]

    def kern(_):
        return K._fakequant_cuda(x, w, adc, rows, instance)

    def plain(_):
        return K._fakequant_plain_lead(x, w, sc, adc, rows)
    ms = cuda_ms(kern, 10, torch.cuda.synchronize)
    plain_ms = cuda_ms(plain, 3, torch.cuda.synchronize)
    n_bytes = 4 * e * (t * k + k * n + t * n)
    flops = 2 * e * t * k * n
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "tc_floor_ms": 1e3 * max(t_bytes, 3 * flops / BF16_FLOPS),
            "bytes_ms": 1e3 * t_bytes}


def phase_moe_fq_kernel(K, AdcConfig, report):
    """Phase 18(b), the kernel: kernel 4 with its lead dim at llama4-scout's
    expert shapes (16 experts, K = 5120, N = 8192, 1024-row tiles) on both
    instances (decode capacity 8, FP32; training capacity 160, tensor
    cores), most experts all-zero as at decode, plus exact-class stacks."""
    torch.cuda.empty_cache()   # the earlier phases' cached blocks
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    adc = AdcConfig()
    rows = [
        fq_lead_case(K, "exact fp32", 4, 8, 256, 512, 64, "exact", gen,
                     adc, "fp32", zero=(1,)),
        fq_lead_case(K, "exact tensor_core", 4, 160, 256, 512, 64, "exact",
                     gen, adc, "tensor_core", zero=(2,)),
        fq_lead_case(K, "llama4 expert stack, decode", 16, 8, 5120, 8192,
                     1024, "float", gen, adc, "fp32",
                     zero=tuple(range(4, 16)), timed=True),
        fq_lead_case(K, "llama4 expert stack, training capacity", 16, 160,
                     5120, 8192, 1024, "float", gen, adc, "tensor_core",
                     zero=(5,), timed=True)]
    for r in rows:
        report(r)
        extra = (f"; {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound "
                 f"{r['bound_ms']:.3f} by {r['bound_by']})"
                 if "ms" in r else "")
        print(f"phase 18(b): fakequant {r['case']} ({r['E']} x {r['T']} x "
              f"{r['K']} by {r['N']}, {r['instance']}) agrees "
              f"({r['max_err_over_bound']:.3f} of the bound, "
              f"{r['zero_experts']} all-zero experts exact){extra}")
    return rows


def fq_serve_timed(M, K, OPS, make_engine, SamplingParams, cfg, what):
    """``cfg`` (fakequant, random weights from torch.Generator seed 0)
    served by the continuous scheduler with phase 2's settings, 16 greedy
    tokens, the launch counts set to 0 just before and read just after.
    Gates: ``moe_reads(cfg)`` fakequant reads a layer a call, 3 of them of
    expert stacks, each read one launch of each of its instance's three
    kernels: the FP32 instance, but for MLA's ``wkv_b`` at decode (B x
    max_len = 256 tokens of the latent cache: the tensor-core instance);
    no plain version on the card.  Returns ``(engine, params, prompts,
    figures)``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    engine = make_engine(cfg, params, n_slots=4, prefill_chunk=16,
                         max_len=64)
    prompts = dense_prompts(cfg, 4)
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()
    plain_calls, stack_reads = [], []
    fq_cuda = K._fakequant_cuda

    def counted(x, w, adc, rows, instance=None):
        if x.ndim == 3:
            stack_reads.append(tuple(x.shape))
        return fq_cuda(x, w, adc, rows, instance)
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    K._fakequant_cuda = counted
    try:
        with counting_plain(K, OPS, plain_calls):
            t0 = time.perf_counter()
            outs = engine.generate(prompts,
                                   SamplingParams(max_new_tokens=16))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        K._fakequant_cuda = fq_cuda
    m = engine.stream.metrics
    calls = m["prefill_chunks"] + m["decode_steps"]
    launches = dict(K.LAUNCHES)
    reads = launches["fakequant"]
    tc = m["decode_steps"] * cfg.n_layers if cfg.use_mla else 0
    by_kernel = {name: launches[c] for name, c in FQ_KERNELS.items()}
    want = {"fakequant_scale_kernel": reads - tc,
            "fakequant_prepare_kernel": tc,
            "fakequant_fp32_kernel": reads - tc, "fakequant_tc_kernel": tc,
            "fakequant_epilogue_kernel": reads}
    n_tok = sum(len(o) for o in outs)
    per_layer = moe_reads(cfg)
    if reads != per_layer * cfg.n_layers * calls or calls == 0 \
            or by_kernel != want \
            or len(stack_reads) != 3 * cfg.n_layers * calls:
        fail(f"{what}: {reads} reads ({len(stack_reads)} of expert stacks) "
             f"in {calls} calls, launches {by_kernel}; expected "
             f"{per_layer * cfg.n_layers} a call, 3 a layer of expert "
             f"stacks, each read one launch of each kernel {want}")
    if plain_calls:
        fail(f"{what} called a plain version {len(plain_calls)} times on "
             "the card")
    if [len(o) for o in outs] != [16] * 4 or \
            not all(0 <= t < cfg.vocab for o in outs for t in o):
        fail(f"{what}: bad outputs {outs}")
    return engine, params, prompts, {
        "tokens": n_tok, "seconds": dt, "tokens_per_s": n_tok / dt,
        "model_calls": calls, "reads": reads, "tensor_core_reads": tc,
        "stack_reads": len(stack_reads), "launches_by_kernel": by_kernel,
        "plain_calls": len(plain_calls)}


def check_fq_reads(K, recorded, what):
    """Every recorded fakequant read (``recording_fq``) against the plain
    version on the card on its own operands, one lead matrix (expert) at
    a time: its DAC scales bit-equal to ``fakequant_scale``, phase 8's
    bound, and an all-zero buffer read as exact zeros."""
    worst = {"max_abs_err": 0.0, "max_err_over_bound": 0.0,
             "zero_experts": 0, "stack_reads": 0}
    for x, w, sc, adc, rows, y in recorded:
        if x.ndim == 2:
            x, w, y = x[None], w[None], y[None]
        else:
            worst["stack_reads"] += 1
        if not torch.equal(sc, K.fakequant_scale(x, adc.in_levels)):
            fail(f"{what}: a read's DAC scales differ from fakequant_scale")
        for i in range(x.shape[0]):
            y_p = K._fakequant_plain(x[i], w[i], sc[i:i + 1], adc, rows)
            if not x[i].any():
                worst["zero_experts"] += 1
                ok, err, over = not y[i].any() and not y_p.any(), 0.0, 0.0
            else:
                ok, err, over, _ = fq_agrees(y[i], y_p, x[i], w[i],
                                             sc[i:i + 1], adc, rows)
            worst["max_abs_err"] = max(worst["max_abs_err"], err)
            worst["max_err_over_bound"] = max(worst["max_err_over_bound"],
                                              over)
            if not ok:
                fail(f"{what}: a read (x {tuple(x.shape)}) disagrees with "
                     f"the plain version at lead {i}: err {err}, {over} of "
                     "the bound")
    return worst


def phase_moe_fq_serve(M, K, OPS, TMoE, make_engine, SamplingParams,
                       get_config, report):
    """Phase 18(b): llama4-scout at full width, 2 layers, served in
    fakequant mode (digital weights behind the crossbar's DAC and ADC)."""
    torch.cuda.empty_cache()   # the earlier phases' cached blocks
    cfg = get_config(MOE_ARCH).replace(n_layers=2, dtype="float32",
                                       analog=True, analog_mode="fakequant")
    torch.cuda.reset_peak_memory_stats()
    engine, params, prompts, serve = fq_serve_timed(
        M, K, OPS, make_engine, SamplingParams, cfg,
        "llama4-scout fakequant serving")
    # a prefill and a decode call, every read on its own operands
    recorded = []
    toks = torch.tensor([prompts[0]], device="cuda")
    with torch.no_grad(), recording_fq(K, recorded):
        logits, cache = M.prefill(params, {"tokens": toks}, cfg, 64)
        M.decode_step(params, cache, logits.argmax(-1), cfg)
    torch.cuda.synchronize()
    worst = check_fq_reads(K, recorded, "llama4-scout fakequant")
    if worst["stack_reads"] != 2 * 3 * cfg.n_layers \
            or worst["zero_experts"] < 1:
        fail(f"llama4-scout fakequant probe: {worst}")
    res = {"config": MOE_ARCH, "cut": "2 of 48 layers, full widths",
           **serve, "probe": worst,
           "profile": profile_decode_step(M, cfg, params),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    report(res)
    print(f"phase 18(b): llama4-scout fakequant served "
          f"{res['tokens_per_s']:.1f} tokens/s ({res['reads']} reads, "
          f"{res['stack_reads']} of expert stacks, one launch of each "
          f"kernel a read: {res['launches_by_kernel']}; no plain version); "
          f"probe reads agree ({worst['max_err_over_bound']:.3f} of the "
          f"bound, {worst['zero_experts']} all-zero experts exact); peak "
          f"{res['peak_memory_gb']:.2f} GB")
    del engine, params
    return res


def phase_moe_train(K, U, TA, TMoE, syn, get_config, report,
                    arch=MOE_ARCH, n_layers=MOE_TRAIN_LAYERS, label="18(c)"):
    """Phase 18(c) (and 19(c)): one device-mode training step of ``arch``
    at full width, cut to ``n_layers`` layer(s): TaOx, lr 0.1, 8 x 256
    tokens (capacity 160 an expert for llama4-scout, 240 for
    deepseek-v2-lite)."""
    torch.cuda.empty_cache()   # the earlier phases' cached blocks
    from repro_torch.core.analog_registry import expert_capacity
    full = get_config(arch)
    cfg = full.replace(dtype="float32", analog=True, analog_mode="device",
                       analog_device="taox", analog_rows=64, analog_cols=64,
                       n_layers=n_layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    state = TA.init_state(gen, cfg, device="cuda")
    step = TA.make_analog_sgd_step(cfg, lr=0.1)
    stream = syn.make_token_stream(200_000, cfg.vocab, seed=0)
    x, y = syn.batch_tokens(stream, 8, 256, 0)
    batch = {"tokens": torch.from_numpy(x).long().cuda(),
             "labels": torch.from_numpy(y).long().cuda()}
    L, per_layer = cfg.n_layers, moe_reads(cfg)
    name = f"{arch} train step"
    # one write a container over its stacked layers (an expert stack over
    # its E * L matrices)
    expect = tensor_core_train_expect(
        L, fakequant=0, **dict.fromkeys(FQ_KERNELS.values(), 0),
        outer_update=per_layer, pulse_update=0, update_tc=per_layer,
        update_prepare=per_layer, update_fp32=0)
    for d in ("vmm", "mvm"):     # seven (nine with MLA) reads a layer
        for c in READ_KERNEL_COUNTS.values():
            if expect[f"{c}_{d}"]:
                expect[f"{c}_{d}"] = per_layer * L
        expect[f"fused_{d}"] = per_layer * L
    reads, routes = [], []
    worst_w = {"max_abs_err": 0.0, "max_err_over_twin_bound": 0.0,
               "max_allowance_share": 0.0, "writes": 0, "stack_writes": 0}
    update_cuda = U._update_cuda

    def checked_write(*args, **kw):
        out = update_cuda(*args, **kw)
        call = write_call(update_cuda, args, kw)
        g = call[0]
        check_writes(U, [(call, out)], f"the {arch} step", worst_w)
        worst_w["writes"] += 1
        worst_w["stack_writes"] += int(g.shape[0] == cfg.n_experts * L)
        return out
    U._update_cuda = checked_write
    reset_launches(K, U)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with recording_reads(K, reads), recording_routes(TMoE, routes):
            state, mets = step(state, batch, 12345)
            torch.cuda.synchronize()
    finally:
        U._update_cuda = update_cuda
    step_ms = 1e3 * (time.perf_counter() - t0)
    got = {**K.LAUNCHES, **U.LAUNCHES}
    if got != expect:
        fail(f"{name} launched {got}; expected {expect}")
    if worst_w["stack_writes"] != 3 or worst_w["writes"] != per_layer:
        fail(f"{name}: {worst_w['writes']} writes, "
             f"{worst_w['stack_writes']} over (E * L, K, N) expert stacks")
    loss = float(mets["loss"])
    if not math.isfinite(loss):
        fail(f"{name}: loss {loss}")
    peak_step_gb = torch.cuda.max_memory_allocated() / 1e9
    worst_r = check_reads(K, reads, where="cuda")
    n_reads = len(reads)
    del reads
    for path, g in tree_leaves(state["params"]):
        if path[-1] == "g" and not (g.min() >= 0 and g.max() <= 1):
            fail(f"{arch}: conductances of {path} left the window")
    dropped = dropped_tokens(routes, cfg)
    prof = profile_train_step(K, U, syn, step, state, stream, gen, expect)
    res = {"config": arch,
           "cut": f"{L} of {full.n_layers} layers, full widths (the "
                  "training step only)",
           "loss": loss, "aux": float(mets["aux"]),
           "step_ms_recorded": step_ms, "launches": got,
           "capacity": expert_capacity(batch["tokens"].numel(), cfg),
           "dropped_pairs": dropped, "reads_checked": n_reads,
           **{f"reads_{k}": v for k, v in worst_r.items()},
           **{f"writes_{k}": v for k, v in worst_w.items()},
           "profile": prof, "peak_step_memory_gb": peak_step_gb,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    report(res)
    print(f"phase {label}: {arch} ({res['cut']}) one device-mode step, "
          f"8 x 256 tokens: loss {loss:.5f}, {dropped} routed pairs dropped "
          f"by capacity; {n_reads} reads ({worst_r['max_err_over_bound']:.3f}"
          f" of the bound, {worst_r['zero_leads']} all-zero experts) and "
          f"{worst_w['writes']} writes ({worst_w['stack_writes']} over "
          f"expert stacks; {worst_w['max_err_over_twin_bound']:.3f} of the "
          f"twin's bound) agree with their plain versions; peak "
          f"{peak_step_gb:.2f} GB in the step")
    del state
    return res


# --------------------------------------------------------------------------
# Phase 19: MLA (deepseek-v2-lite-16b) at full width
# --------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-lite-16b"
#: Crossbar reads an MLA MoE layer makes per model call: wq, wkv_a, wkv_b,
#: wo, the shared experts' w_upgate and w_down, one read of each expert
#: stack.
MLA_READS = 9
#: The served depth: a full-width layer holds 584.7 M cells in each of g
#: and ref (4.68 GB) and 2.34 GB of programming targets, the embedding
#: and head 1.68 GB: about 30 GB at 4 layers (191 GB at all 27).
MLA_SERVE_LAYERS = 4
#: The training step's depth: 9.4 GB of g + ref and 4.7 GB of new
#: conductances at 2 layers, before the activations and the head.
MLA_TRAIN_LAYERS = 2
#: The serving cache length: every decode step re-expands B x max_len
#: latent rows through wkv_b.
MLA_MAX_LEN = 64


@contextlib.contextmanager
def recording_instances(K, instances):
    """Record the instance every forward or transpose read ran on
    (``"tensor_core"`` when it launched ``tc_read_kernel``, else
    ``"fp32"``), in the order of ``recording_reads``."""
    read_cuda = K._read_cuda

    def recorded(x, g, ref, sc, cfg, transpose=False):
        key = "tc_read_mvm" if transpose else "tc_read_vmm"
        before = K.LAUNCHES[key]
        y = read_cuda(x, g, ref, sc, cfg, transpose)
        instances.append("tensor_core" if K.LAUNCHES[key] > before
                         else "fp32")
        return y

    K._read_cuda = recorded
    try:
        yield
    finally:
        K._read_cuda = read_cuda


@contextlib.contextmanager
def recording_chunks(M, chunks):
    """Record every ``models.model.prefill_chunk`` call: ``(tokens,
    logits)``."""
    prefill_chunk = M.prefill_chunk

    def recorded(params, cache, tokens, cfg):
        logits, cache = prefill_chunk(params, cache, tokens, cfg)
        chunks.append((tokens.clone(), logits.detach().clone()))
        return logits, cache

    M.prefill_chunk = recorded
    try:
        yield
    finally:
        M.prefill_chunk = prefill_chunk


@contextlib.contextmanager
def env_set(name, value):
    """``os.environ[name] = value`` for the block, restored after."""
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name)
        else:
            os.environ[name] = prev


def idle_experts(routes, cfg, n_slots=4):
    """The share of expert-stack reads whose (capacity, d) buffer was all
    zero (an expert no routed pair reached), from the recorded routing
    calls: over the decode calls (``n_slots`` tokens) and over all."""
    idle = {"decode": [0, 0], "all": [0, 0]}
    for _, _, top_i in routes:
        n = cfg.n_experts - int(torch.unique(top_i).numel())
        for key in ("all", "decode") if top_i.shape[0] == n_slots \
                else ("all",):
            idle[key][0] += n
            idle[key][1] += cfg.n_experts
    return {f"idle_expert_share_{k}": (a / b if b else None)
            for k, (a, b) in idle.items()}


def phase_mla_serve(M, K, TT, TMoE, make_engine, SamplingParams, get_config,
                    report):
    """Phase 19(a): deepseek-v2-lite at full width, ``MLA_SERVE_LAYERS``
    layers, served from expert-batched crossbars (see the module
    docstring)."""
    torch.cuda.empty_cache()   # the earlier phases' cached blocks
    full = get_config(MLA_ARCH)
    cfg = device_serve_cfg(full, MLA_SERVE_LAYERS)
    L = cfg.n_layers
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine(cfg, program_model(M, cfg), backend="analog",
                         n_slots=4, prefill_chunk=16, max_len=MLA_MAX_LEN)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    params = engine.params
    resident_gb = torch.cuda.memory_allocated() / 1e9
    shapes = {("moe", "experts", "w_up"): (L, cfg.n_experts, cfg.d_model,
                                           cfg.d_ff_expert),
              ("attn", "wkv_b"): (L, cfg.kv_lora_rank, cfg.n_heads
                                  * (cfg.qk_nope_dim + cfg.v_head_dim))}
    for path, want in shapes.items():
        got = tuple(tree_get(params["layers"], path)["g"].shape)
        if got != want:
            fail(f"deepseek-v2-lite container {path}: g {got}, expected "
                 f"{want}")
    wkv_b = shapes[("attn", "wkv_b")][1:]
    cells = sum(v.numel() for path, v in tree_leaves(params)
                if path[-1] == "g")
    print(f"phase 19: deepseek-v2-lite ({L} of {full.n_layers} layers, "
          f"full widths) programmed in {program_s:.1f} s: "
          f"{cells / 1e9:.3f} B cells in g, {resident_gb:.2f} GB resident "
          f"({start_gb:.2f} GB allocated before)")
    prompts = dense_prompts(cfg, 4)
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))
    routes = []
    with recording_routes(TMoE, routes):
        outs, serve = timed_serve(K, engine, prompts,
                                  SamplingParams(max_new_tokens=16), cfg,
                                  "deepseek-v2-lite serve",
                                  per_layer=MLA_READS, tc_per_layer=1)
    serve["dropped_pairs"] = dropped_tokens(routes, cfg)
    serve.update(idle_experts(routes, cfg))
    # one scheduler tick: a prefill chunk (one row) and a decode call (4
    # slots), every read held on its own operands
    reads, instances, routes, chunks = [], [], [], []
    eng = engine.stream
    eng.reset()
    for p in prompts:
        eng.submit(p, SamplingParams(max_new_tokens=2))
    with torch.no_grad(), recording_reads(K, reads), \
            recording_instances(K, instances), \
            recording_routes(TMoE, routes), recording_chunks(M, chunks):
        eng.step()
    torch.cuda.synchronize()
    if (eng.metrics["prefill_chunks"], eng.metrics["decode_steps"]) != (1, 1) \
            or len(reads) != 2 * MLA_READS * L or len(chunks) != 1:
        fail(f"deepseek-v2-lite: one tick made {dict(eng.metrics)}, "
             f"{len(reads)} reads; expected a prefill chunk and a decode "
             f"call of {MLA_READS * L} reads each")
    while eng.has_work():
        eng.step()
    wkv_b_rows = []
    for i, ((x, g, *_), inst) in enumerate(zip(reads, instances)):
        if tuple(g.shape[1:]) != wkv_b:
            continue
        rows = 1 if i < MLA_READS * L else eng.n_slots
        wkv_b_rows.append((x.shape[1], inst))
        if x.shape[1] != rows * MLA_MAX_LEN or inst != "tensor_core":
            fail(f"deepseek-v2-lite: a wkv_b read took {x.shape[1]} rows "
                 f"on the {inst} instance; expected {rows} x "
                 f"{MLA_MAX_LEN} (the whole latent cache) on the tensor "
                 "cores")
    if len(wkv_b_rows) != 2 * L:
        fail(f"deepseek-v2-lite: {len(wkv_b_rows)} wkv_b reads in a tick")
    worst = check_reads(K, reads, where="cuda")
    worst["reads_checked"] = len(reads)
    if worst["zero_leads"] < 1:
        fail("deepseek-v2-lite: no expert read an all-zero buffer")
    # the prefill chunk's logits on the CPU, reads and routing replayed
    toks, card_logits = chunks[0]
    cpu_params = meta_containers(params)
    cpu_logits, route_flips = moe_replay_cpu(
        M, TT, TMoE, cfg, cpu_params, toks, reads[:MLA_READS * L],
        routes[:L], run=lambda p: M.prefill_chunk(
            p, M.init_cache(cfg, 1, MLA_MAX_LEN, "cpu"), toks.cpu(),
            cfg)[0])
    del cpu_params
    replay_diff = (card_logits.cpu() - cpu_logits).abs().max().item()
    if not replay_diff <= 1e-3:
        fail(f"deepseek-v2-lite: card and CPU prefill-chunk logits differ "
             f"by {replay_diff} with the reads and routing replayed")
    profile = profile_decode_step(
        M, cfg, params, "crossbar", ("fused_read_tile", "reduce_tiles",
                                     "read_prepare", "tc_range", "tc_read"),
        max_len=MLA_MAX_LEN)
    profile.update(expert_read_ms(K, M, cfg, params, cfg.n_experts,
                                  max_len=MLA_MAX_LEN))
    if profile.get("device_ms"):
        profile["expert_read_share"] = \
            profile["expert_read_ms"] / profile["device_ms"]
    energy = engine.energy_per_token()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = {"config": MLA_ARCH,
           "cut": f"{L} of {full.n_layers} layers, full widths",
           "cells": cells, "program_s": program_s,
           "resident_gb": resident_gb, "allocated_before_gb": start_gb,
           "serve": serve, "probe_reads": worst,
           "wkv_b_rows_and_instance": wkv_b_rows,
           "replay_max_abs_logit_diff": replay_diff,
           "max_abs_logit": card_logits.abs().max().item(),
           "route_choices_differing_on_cpu": route_flips,
           "decode_profile": profile, "peak_memory_gb": peak_gb,
           "energy_per_token": energy}
    report(res)
    print(f"phase 19(a): deepseek-v2-lite served "
          f"{serve['tokens_per_s']:.1f} tokens/s from crossbars "
          f"({serve['reads']} reads in {serve['model_calls']} calls, wkv_b "
          f"on the tensor cores; {serve['dropped_pairs']} routed pairs "
          f"dropped; idle experts {serve['idle_expert_share_decode']:.3f} "
          f"of the decode reads, {serve['idle_expert_share_all']:.3f} of "
          f"all); {worst['reads_checked']} probe reads agree "
          f"({worst['max_err_over_bound']:.3f} of the bound, "
          f"{worst['zero_leads']} all-zero experts read exact zeros; wkv_b "
          f"rows {[r for r, _ in wkv_b_rows]}); replayed CPU logits "
          f"{replay_diff:.3g} off, {route_flips} routing choices differ on "
          f"the CPU; decode step device {profile.get('device_ms', 0):.2f} "
          f"ms, expert reads {profile['expert_read_ms']:.2f} ms "
          f"({100 * profile.get('expert_read_share', 0):.0f}% of it) for "
          f"{profile['expert_read_bytes'] / 1e9:.1f} GB (bound "
          f"{profile['expert_read_bound_ms']:.2f} ms); resident "
          f"{resident_gb:.2f} GB, peak {peak_gb:.2f} GB")
    del engine, params
    return res


def expert_stacks_meta(params, path=()):
    """A CPU copy of a fakequant tree whose expert stacks are shapes only
    (meta tensors): the replayed CPU run reads them only through the
    fakequant read, which replays the card's results."""
    if isinstance(params, dict):
        return {k: expert_stacks_meta(v, path + (k,))
                for k, v in params.items()}
    return params.to("meta") if "experts" in path else params.cpu()


def phase_mla_fq_serve(M, K, OPS, TT, TMoE, make_engine, SamplingParams,
                       get_config, report):
    """Phase 19(b): deepseek-v2-lite at full width, ``MLA_SERVE_LAYERS``
    layers, served in fakequant mode, and a probe: a (4, 12) prefill, a
    decode step and a decode step with ``REPRO_MLA_ABSORB=1`` (the
    variable restored after it), every read held on its own operands per
    lead matrix, the logits against a CPU run with the card's reads and
    routing replayed, within 1e-3."""
    torch.cuda.empty_cache()   # the earlier phases' cached blocks
    full = get_config(MLA_ARCH)
    cfg = full.replace(n_layers=MLA_SERVE_LAYERS, dtype="float32",
                       analog=True, analog_mode="fakequant")
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    engine, params, _, serve = fq_serve_timed(
        M, K, OPS, make_engine, SamplingParams, cfg,
        "deepseek-v2-lite fakequant serving")
    recorded, routes = [], []
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 12))).cuda()
    card = []
    with torch.no_grad(), recording_fq(K, recorded), \
            recording_routes(TMoE, routes):
        logits, cache = M.prefill(params, {"tokens": toks}, cfg, MLA_MAX_LEN)
        card.append(logits)
        fed = [logits.argmax(-1)]
        logits, cache = M.decode_step(params, cache, fed[0], cfg)
        card.append(logits)
        fed.append(logits.argmax(-1))
        n_expanded = len(recorded)
        with env_set("REPRO_MLA_ABSORB", "1"):
            logits, cache = M.decode_step(params, cache, fed[1], cfg)
        card.append(logits)
    torch.cuda.synchronize()
    if os.environ.get("REPRO_MLA_ABSORB"):
        fail("REPRO_MLA_ABSORB was not restored")
    n_absorbed = len(recorded) - n_expanded
    tc_wkv_b = [x.shape for x, w, *_ in recorded[MLA_READS * L:n_expanded]
                if tuple(w.shape) == (cfg.kv_lora_rank, cfg.n_heads
                                      * (cfg.qk_nope_dim + cfg.v_head_dim))]
    if n_expanded != 2 * MLA_READS * L or n_absorbed != (MLA_READS - 1) * L \
            or [tuple(s) for s in tc_wkv_b] != [(4 * MLA_MAX_LEN,
                                                 cfg.kv_lora_rank)] * L:
        fail(f"deepseek-v2-lite fakequant probe: {n_expanded} reads in the "
             f"prefill and decode step (wkv_b at decode {tc_wkv_b}), "
             f"{n_absorbed} in the absorbed decode step; expected "
             f"{MLA_READS * L} a call, wkv_b at {4 * MLA_MAX_LEN} tokens, "
             f"and no wkv_b read when absorbed")
    worst = check_fq_reads(K, recorded, "deepseek-v2-lite fakequant")
    if worst["stack_reads"] != 3 * 3 * L or worst["zero_experts"] < 1:
        fail(f"deepseek-v2-lite fakequant probe: {worst}")

    def run_cpu(p):
        out = []
        lg, c = M.prefill(p, {"tokens": toks.cpu()}, cfg, MLA_MAX_LEN)
        out.append(lg)
        lg, c = M.decode_step(p, c, fed[0].cpu(), cfg)
        out.append(lg)
        with env_set("REPRO_MLA_ABSORB", "1"):
            out.append(M.decode_step(p, c, fed[1].cpu(), cfg)[0])
        return out
    cpu_params = expert_stacks_meta(params)
    cpu, route_flips = moe_replay_cpu(M, TT, TMoE, cfg, cpu_params, toks,
                                      recorded, routes, run=run_cpu, OPS=OPS)
    del cpu_params
    diffs = [(a.cpu() - b).abs().max().item() for a, b in zip(card, cpu)]
    if not max(diffs) <= 1e-3:
        fail(f"deepseek-v2-lite fakequant: card and CPU logits (prefill, "
             f"decode, absorbed decode) differ by {diffs} with the reads "
             f"and routing replayed")
    res = {"config": MLA_ARCH,
           "cut": f"{L} of {full.n_layers} layers, full widths",
           **serve, "probe": worst,
           "replay_max_abs_logit_diff": diffs,
           "route_choices_differing_on_cpu": route_flips,
           "profile": profile_decode_step(M, cfg, params,
                                          max_len=MLA_MAX_LEN),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    report(res)
    print(f"phase 19(b): deepseek-v2-lite fakequant served "
          f"{res['tokens_per_s']:.1f} tokens/s ({res['reads']} reads, "
          f"{res['stack_reads']} of expert stacks, "
          f"{res['tensor_core_reads']} on the tensor cores (wkv_b at "
          f"decode); no plain version); probe reads agree "
          f"({worst['max_err_over_bound']:.3f} of the bound, "
          f"{worst['zero_experts']} all-zero experts exact); replayed CPU "
          f"logits {['%.3g' % d for d in diffs]} off (prefill, decode, "
          f"absorbed decode), {route_flips} routing choices differ; decode "
          f"step device {res['profile'].get('device_ms', 0):.2f} ms; peak "
          f"{res['peak_memory_gb']:.2f} GB")
    del engine, params
    return res


# --------------------------------------------------------------------------
# Phases 20-21: the SSM (mamba2-1.3b) and hybrid (zamba2-1.2b) families
# --------------------------------------------------------------------------

SSM_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "zamba2-1.2b"
#: The training steps' depths: mamba2 at 8 of 48 layers; zamba2 at 13 of
#: 38, two groups of 6 SSD layers each followed by the shared block and
#: one trailing layer.
SSM_TRAIN_LAYERS = 8
HYBRID_TRAIN_LAYERS = 13
#: The card's final SSM states against the replayed CPU run's: within
#: this share of the largest |h| (the scan's float32 sums are taken in
#: another order on each side; the reads are replayed).
SSM_STATE_TOL = 1e-3


def crossbar_leaf(path):
    """Whether the leaf at ``path`` is a crossbar consumer's matrix: a
    device-mode container's ``g`` or a fakequant tree's projection ``w``
    (``analog_registry.classify_param``)."""
    from repro_torch.core.analog_registry import classify_param
    return path[-1] in ("g", "w") \
        and classify_param(path) not in (None, "digital")


def ssm_reads(params, cfg):
    """Crossbar (or fakequant) reads of one model call of an SSM or
    hybrid tree: each matrix once a layer of its stack and once an
    application (``analog_registry.tape_reps``: the hybrid's shared block
    once a group)."""
    from repro_torch.core.analog_registry import tape_reps
    return sum(math.prod(v.shape[:-2]) * tape_reps(path, cfg)
               for path, v in tree_leaves(params) if crossbar_leaf(path))


def left_padded(prompts):
    """The static scheduler's prefill batch: prompts right-aligned,
    left-padded with 0."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return torch.from_numpy(toks).cuda()


def ssm_probe(K, M, TT, TMoE, cfg, params, prompts, what):
    """A left-padded prefill of ``prompts`` (the tensor-core instance) and
    one decode step (the FP32 instance), every read held against its
    plain version on the card on its own operands (phase 1's bound, its
    DAC scale the float32 division); the prefill's logits and final SSM
    states against a CPU run with the card's reads replayed."""
    per_call = ssm_reads(params, cfg)
    toks = left_padded(prompts)
    reads = []
    with torch.no_grad(), recording_reads(K, reads):
        logits, cache = M.prefill(params, {"tokens": toks}, cfg, 64)
        h_card = cache[0]["h"].clone()
        M.decode_step(params, cache, logits.argmax(-1), cfg)
    torch.cuda.synchronize()
    if len(reads) != 2 * per_call:
        fail(f"{what}: {len(reads)} reads in a prefill and a decode step; "
             f"expected {2 * per_call}")
    worst = check_reads(K, reads, where="cuda")
    worst["reads_checked"] = len(reads)
    cpu_params = meta_containers(params)
    (cpu_logits, cpu_cache), _ = moe_replay_cpu(
        M, TT, TMoE, cfg, cpu_params, toks, reads[:per_call], [],
        run=lambda p: M.prefill(p, {"tokens": toks.cpu()}, cfg, 64))
    del cpu_params
    logit_diff = (logits.cpu() - cpu_logits).abs().max().item()
    h_cpu = cpu_cache[0]["h"]
    h_diff = (h_card.cpu() - h_cpu).abs().max().item()
    h_share = h_diff / max(h_cpu.abs().max().item(), 1e-30)
    if not logit_diff <= 1e-3 or not h_share <= SSM_STATE_TOL:
        fail(f"{what}: card and CPU prefill differ with the reads "
             f"replayed: logits {logit_diff} (bound 1e-3), final SSM "
             f"states {h_diff} ({h_share:.3g} of the largest, bound "
             f"{SSM_STATE_TOL})")
    return worst, {"replay_max_abs_logit_diff": logit_diff,
                   "max_abs_logit": logits.abs().max().item(),
                   "replay_max_abs_state_diff": h_diff,
                   "replay_state_diff_share": h_share,
                   "max_abs_state": h_card.abs().max().item()}


def decode_read_bytes(params, cfg):
    """g and ref bytes one decode step reads: every container once an
    application (``analog_registry.tape_reps``: the hybrid's shared block
    once a group)."""
    from repro_torch.core.analog_registry import tape_reps
    return sum(8 * g.numel() * tape_reps(path, cfg)
               for path, g in tree_leaves(params) if path[-1] == "g")


def phase_ssm_serve(M, K, TT, TMoE, make_engine, SamplingParams, get_config,
                    arch, report, label):
    """Phase 20(a) / 21(a): ``arch`` at full size from ``taox-nonoise``
    64x64 crossbars, served by the static scheduler (see the module
    docstring)."""
    torch.cuda.empty_cache()   # the earlier phases' cached blocks
    cfg = device_serve_cfg(get_config(arch))
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine(cfg, program_model(M, cfg), backend="analog",
                         max_len=64)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    params = engine.params
    resident_gb = torch.cuda.memory_allocated() / 1e9
    cells = sum(v.numel() for path, v in tree_leaves(params)
                if path[-1] == "g")
    print(f"phase {label}: {arch} ({cfg.n_layers} layers, full size) "
          f"programmed in {program_s:.1f} s: {cells / 1e9:.3f} B cells in "
          f"g, {resident_gb:.2f} GB resident ({start_gb:.2f} GB allocated "
          "before)")
    prompts = dense_prompts(cfg, 4)
    engine.generate(prompts, SamplingParams(max_new_tokens=2))  # warm-up
    _, serve = static_serve(K, engine, cfg, prompts,
                            SamplingParams(max_new_tokens=16),
                            f"{arch} serve")
    worst, replay = ssm_probe(K, M, TT, TMoE, cfg, params, prompts, arch)
    profile = profile_decode_step(M, cfg, params, "crossbar",
                                  ("fused_read_tile", "reduce_tiles"))
    n_bytes = decode_read_bytes(params, cfg)
    profile["read_bytes"] = n_bytes
    profile["read_bound_ms"] = 1e3 * n_bytes / HBM_BYTES_PER_S
    energy = engine.energy_per_token()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = {"config": arch, "cut": f"none: {cfg.n_layers} layers, full size",
           "cells": cells, "program_s": program_s,
           "resident_gb": resident_gb, "allocated_before_gb": start_gb,
           "serve": serve, "probe_reads": worst, **replay,
           "decode_profile": profile, "peak_memory_gb": peak_gb,
           "energy_per_token": energy}
    report(res)
    print(f"phase {label}: {arch} served {serve['tokens_per_s']:.1f} "
          f"tokens/s from crossbars, static scheduler ({serve['reads']} "
          f"reads in {serve['model_calls']} calls, "
          f"{ssm_reads(params, cfg)} a "
          f"call); {worst['reads_checked']} probe reads agree "
          f"({worst['max_err_over_bound']:.3f} of the bound); replayed CPU "
          f"logits {replay['replay_max_abs_logit_diff']:.3g} off, final "
          f"states {replay['replay_state_diff_share']:.3g} of the largest; "
          f"decode step device {profile.get('device_ms') or 0:.2f} ms, "
          f"reads {profile.get('crossbar_read_ms', 0):.2f} ms for "
          f"{n_bytes / 1e9:.2f} GB (bound {profile['read_bound_ms']:.2f} "
          f"ms); resident {resident_gb:.2f} GB, peak {peak_gb:.2f} GB; "
          f"energy/token analog {energy['analog_pj']:.4g} pJ")
    del engine, params
    return res


def phase_ssm_fq_serve(M, K, OPS, TT, TMoE, make_engine, SamplingParams,
                       get_config, report):
    """Phase 20(b): mamba2-1.3b at full size in fakequant mode (the
    default 1024-row tiles, 8-bit), served by the static scheduler, 16
    greedy tokens: ``ssm_reads`` fakequant reads a call, each one launch
    of each of the FP32 instance's three kernels (the prefill's 4 x 16
    rows and decode's 4 stay under ``FQ_TC_MIN_TOKENS``), no plain
    version on the card; a prefill and a decode step, every read held
    on its own operands, the prefill's logits against a CPU run with the
    card's reads replayed, within 1e-3."""
    torch.cuda.empty_cache()
    cfg = get_config(SSM_ARCH).replace(dtype="float32", analog=True,
                                       analog_mode="fakequant")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    engine = make_engine(cfg, params, max_len=64)
    prompts = dense_prompts(cfg, 4)
    per_call = ssm_reads(params, cfg)
    engine.generate(prompts, SamplingParams(max_new_tokens=2))
    _, serve = static_serve(K, engine, cfg, prompts,
                            SamplingParams(max_new_tokens=16),
                            "mamba2 fakequant serving", OPS)
    if serve["tensor_core_reads"]:
        fail(f"mamba2 fakequant serving: {serve['tensor_core_reads']} "
             "reads on the tensor-core instance")
    recorded = []
    toks = left_padded(prompts)
    with torch.no_grad(), recording_fq(K, recorded):
        logits, cache = M.prefill(params, {"tokens": toks}, cfg, 64)
        M.decode_step(params, cache, logits.argmax(-1), cfg)
    torch.cuda.synchronize()
    if len(recorded) != 2 * per_call:
        fail(f"mamba2 fakequant probe: {len(recorded)} reads")
    worst = check_fq_reads(K, recorded, "mamba2 fakequant")
    cpu_params = meta_containers(params, crossbar_leaf)
    cpu_logits, _ = moe_replay_cpu(
        M, TT, TMoE, cfg, cpu_params, toks, recorded[:per_call], [],
        OPS=OPS)
    del cpu_params
    diff = (logits.cpu() - cpu_logits).abs().max().item()
    if not diff <= 1e-3:
        fail(f"mamba2 fakequant: card and CPU prefill logits differ by "
             f"{diff} with the reads replayed")
    res = {"config": SSM_ARCH, "cut": "none: 48 layers, full size",
           **serve, "probe": worst, "replay_max_abs_logit_diff": diff,
           "profile": profile_decode_step(M, cfg, params),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    report(res)
    print(f"phase 20(b): mamba2 fakequant served {res['tokens_per_s']:.1f} "
          f"tokens/s ({serve['reads']} reads, one launch of each "
          f"FP32-instance kernel a read; no plain version); probe reads agree "
          f"({worst['max_err_over_bound']:.3f} of the bound); replayed CPU "
          f"logits {diff:.3g} off; decode step device "
          f"{res['profile'].get('device_ms') or 0:.2f} ms; peak "
          f"{res['peak_memory_gb']:.2f} GB")
    del engine, params
    return res


def ssd_scan_ms(TS, cfg):
    """Device time (profiler: the kernels' own time, the host's gaps
    left out) of one layer's chunked SSD scan, forward and backward,
    alone, at a training step's shapes (8 x 256 tokens, random inputs):
    the step's scan is ``n_layers`` of these; None if the profiler
    recorded no kernel."""
    b, s = 8, 256
    _, h, n, g = TS._dims(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).requires_grad_(True)
    xh = rand(b, s, h, cfg.ssm_head_dim)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device="cuda")
        - 4.0).requires_grad_(True)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda")
                      ).requires_grad_(True)
    bmat, cmat = rand(b, s, g, n, scale=0.3), rand(b, s, g, n, scale=0.3)

    def run(_):
        y, hl = TS._ssd_chunked(xh, dt, a_log, bmat, cmat, cfg.ssm_chunk)
        (y.square().sum() + hl.square().sum()).backward()
    return device_ms(run, 3)


def fp32_write_agrees(U, g, x_q, d_q, scale, noise, seed, wcfg, mode, out,
                      offs=(0, 0, 0)):
    """A write on the FP32 instance (float operands) against its plain
    version on the same operands and noise field (at the write's tile
    offsets): ``update_bound`` on every cell.  Returns (ok, max abs err,
    largest err / bound)."""
    g_p = U._update_plain(g, x_q, d_q, scale, noise, seed, wcfg, mode, offs)
    err = (out - g_p).abs()
    over = (err / update_bound(g_p, g)).max().item()
    return over <= 1.0, err.max().item(), over


def phase_ssm_train(K, U, TA, TS, syn, get_config, report, arch, n_layers,
                    label):
    """Phase 20(c) / 21(b): one device-mode training step of ``arch`` at
    full width cut to ``n_layers`` layers: TaOx, 64x64 tiles, lr 0.1, 8 x
    256 tokens (see the module docstring)."""
    torch.cuda.empty_cache()
    full = get_config(arch)
    cfg = full.replace(dtype="float32", analog=True, analog_mode="device",
                       analog_device="taox", analog_rows=64, analog_cols=64,
                       n_layers=n_layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    state = TA.init_state(gen, cfg, device="cuda")
    step = TA.make_analog_sgd_step(cfg, lr=0.1)
    stream = syn.make_token_stream(200_000, cfg.vocab, seed=0)
    x, y = syn.batch_tokens(stream, 8, 256, 0)
    batch = {"tokens": torch.from_numpy(x).long().cuda(),
             "labels": torch.from_numpy(y).long().cuda()}
    n_reads = ssm_reads(state["params"], cfg)
    # the containers applied several times a step (the hybrid's shared
    # block), and how often
    from repro_torch.core.analog_registry import container_paths, tape_reps
    shared = {path: tape_reps(path, cfg)
              for path in container_paths(state["params"])
              if tape_reps(path, cfg) > 1}
    n_shared = len(shared)
    reps = max(shared.values(), default=0)
    # the SSD stacks' two writes on the tensor cores, the shared block's
    # five on the FP32 instance (float operands, no code scales)
    expect = tensor_core_train_expect(
        n_layers, fakequant=0, **dict.fromkeys(FQ_KERNELS.values(), 0),
        outer_update=2 + n_shared, pulse_update=0, update_tc=2,
        update_prepare=2, update_fp32=n_shared)
    for d in ("vmm", "mvm"):
        for c in READ_KERNEL_COUNTS.values():
            if expect[f"{c}_{d}"]:
                expect[f"{c}_{d}"] = n_reads
        expect[f"fused_{d}"] = n_reads
    name = f"{arch} train step"
    reads, slots = [], {}
    worst_tc = {"max_abs_err": 0.0, "max_err_over_twin_bound": 0.0,
                "max_allowance_share": 0.0}
    worst_fp = {"max_abs_err": 0.0, "max_err_over_bound": 0.0, "rows": [],
                "shapes": []}
    update_cuda = U._update_cuda
    update_container = TA.AnalogTrainStep._update_container

    def checked_write(*args, **kw):
        out = update_cuda(*args, **kw)
        call = write_call(update_cuda, args, kw)
        g, x_q, d_q, scale, noise, seed, wcfg, mode, x_scale, _, offs = call
        if x_scale is not None:
            if g.shape[0] != n_layers:
                fail(f"{name}: a tensor-core write over {tuple(g.shape)}")
            check_writes(U, [(call, out)], name, worst_tc)
        else:
            ok, err, over = fp32_write_agrees(U, g, x_q, d_q, scale, noise,
                                              seed, wcfg, mode, out, offs)
            worst_fp["max_abs_err"] = max(worst_fp["max_abs_err"], err)
            worst_fp["max_err_over_bound"] = max(
                worst_fp["max_err_over_bound"], over)
            worst_fp["rows"].append(x_q.shape[1])
            worst_fp["shapes"].append(tuple(g.shape))
            if not ok:
                fail(f"{name}: an FP32-instance write of {tuple(g.shape)} "
                     f"disagrees with its plain version: err {err}, "
                     f"{over} of update_bound")
        return out

    def slot_checked(self, p, tapes, seed_base, path, rail):
        """The shared block's tapes: one (T, K) / (T, N) slot and one pair
        of code scales per application, the slots distinct."""
        if path in shared:
            xt, xs = tapes["x_tape"], tapes["x_tape_scale"]
            if tuple(xt.shape[:2]) != (reps, 2048) \
                    or tuple(xs.shape) != (reps,) \
                    or torch.equal(xt[0], xt[1]) \
                    or torch.equal(tapes["d_tape"][0], tapes["d_tape"][1]):
                fail(f"{name}: {path} tapes {tuple(xt.shape)}, scales "
                     f"{tuple(xs.shape)}; expected {reps} distinct "
                     "application slots of 2048 rows")
            slots[path] = {"x_scale": xs.tolist(),
                           "d_scale": tapes["d_tape_scale"].tolist()}
        return update_container(self, p, tapes, seed_base, path, rail)
    U._update_cuda = checked_write
    TA.AnalogTrainStep._update_container = slot_checked
    reset_launches(K, U)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with recording_reads(K, reads):
            state, mets = step(state, batch, 12345)
            torch.cuda.synchronize()
    finally:
        U._update_cuda = update_cuda
        TA.AnalogTrainStep._update_container = update_container
    step_ms = 1e3 * (time.perf_counter() - t0)
    got = {**K.LAUNCHES, **U.LAUNCHES}
    if got != expect:
        fail(f"{name} launched {got}; expected {expect}")
    if worst_fp["rows"] != [reps * 2048] * n_shared \
            or len(slots) != n_shared:
        fail(f"{name}: FP32-instance writes over {worst_fp['rows']} rows, "
             f"{len(slots)} shared containers' slots seen")
    loss = float(mets["loss"])
    if not math.isfinite(loss):
        fail(f"{name}: loss {loss}")
    peak_step_gb = torch.cuda.max_memory_allocated() / 1e9
    worst_r = check_reads(K, reads, where="cuda")
    n_checked = len(reads)
    del reads
    for path, g in tree_leaves(state["params"]):
        if path[-1] == "g" and not (g.min() >= 0 and g.max() <= 1):
            fail(f"{arch}: conductances of {path} left the window")
    prof = profile_train_step(K, U, syn, step, state, stream, gen, expect)
    per_layer = ssd_scan_ms(TS, cfg)
    prof["ssd_scan_ms_alone_per_layer"] = per_layer
    prof["ssd_scan_ms_alone"] = None if per_layer is None \
        else n_layers * per_layer
    shared_ms = prof["device_ms_by_group"].get(
        "rank-k writes (FP32 instance)", 0.0)
    res = {"config": arch,
           "cut": f"{n_layers} of {full.n_layers} layers, full widths (the "
                  "training step only)",
           "loss": loss, "step_ms_recorded": step_ms, "launches": got,
           "reads_checked": n_checked,
           **{f"reads_{k}": v for k, v in worst_r.items()},
           **{f"tc_writes_{k}": v for k, v in worst_tc.items()},
           **{f"fp32_writes_{k}": v for k, v in worst_fp.items()},
           "shared_slot_scales": {"/".join(p): v for p, v in slots.items()},
           "shared_fp32_writes_ms": shared_ms, "profile": prof,
           "peak_step_memory_gb": peak_step_gb,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    report(res)
    print(f"phase {label}: {arch} ({res['cut']}) one device-mode step, 8 x "
          f"256 tokens: loss {loss:.5f}; {n_checked} reads "
          f"({worst_r['max_err_over_bound']:.3f} of the bound), 2 "
          f"tensor-core writes ({worst_tc['max_err_over_twin_bound']:.3f} "
          f"of the twin's bound) and {n_shared} FP32-instance shared-block "
          f"writes over {reps} x 2048 rows "
          f"({worst_fp['max_err_over_bound']:.3f} of update_bound; "
          f"{shared_ms:.2f} ms in the profiled step) agree with their plain "
          f"versions; SSD scan alone {prof['ssd_scan_ms_alone'] or 0:.2f} "
          f"ms fwd+bwd over {n_layers} layers (device time); peak "
          f"{peak_step_gb:.2f} GB in the step")
    del state
    return res


def phase_shared_write_kernel(U, IDEAL, CrossbarConfig, report):
    """Phase 21(b), the kernel: the FP32 write instance at the shared
    block's ``w_upgate`` (2048 x 16384) over 2 x 2048 rows, on an ideal
    device with power-of-two scales (every sum exact): bit-equal to its
    plain version."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    cfg = CrossbarConfig(rows=64, cols=64, device=IDEAL)
    g, x_q, d_q, scale, _, _ = update_operands(1, 2048, 16384, 2 * 2048,
                                               gen, pow2=True)
    row = {"container": "shared_ffn/w_upgate", "L": 1, "K": 2048,
           "N": 16384, "T": 2 * 2048, "case": "ideal, power-of-two"}
    row.update(write_case(U, g, x_q, d_q, scale, None, None, None, None,
                          "none", cfg, exact=True, fp32=True, timed=False))
    report(row)
    print(f"phase 21(b): FP32 write at {row['K']} x {row['N']} over "
          f"{row['T']} rows bit-equal to its plain version (ideal, "
          f"power-of-two)")
    return row


# --------------------------------------------------------------------------
# Phases 22-23: the cross-attention families
# --------------------------------------------------------------------------

AUDIO_ARCH = "whisper-medium"
VLM_ARCH = "llama-3.2-vision-90b"
#: llama-3.2-vision-90b's depths on the card, of its 100 layers: one
#: group (the cross layer and its four self layers) from crossbars and in
#: the training step; two groups in fakequant mode (float32 weights, no
#: programming targets), so that the group loop runs twice.
VLM_SERVE_LAYERS = 5
VLM_FQ_LAYERS = 10
VLM_TRAIN_LAYERS = 5
#: whisper-medium's depth on the card, encoder and decoder each (of 24):
#: cut for the script's time limit once phase 29 joined.
AUDIO_LAYERS = 8


def cut_depth(cfg, n_layers):
    """``cfg`` at ``n_layers`` layers (the audio model's encoder too)."""
    if not n_layers:
        return cfg
    enc = {"n_encoder_layers": n_layers} if cfg.n_encoder_layers else {}
    return cfg.replace(n_layers=n_layers, **enc)
#: The training steps' token batches (B, S): whisper-medium 4 x 128 with
#: 4 x 1500 frames, the VLM 2 x 128 with 2 x 1024 vision tokens.
CROSS_TRAIN_SHAPE = {AUDIO_ARCH: (4, 128), VLM_ARCH: (2, 128)}
#: The kernels of a crossbar read, as the profiler names them.
READ_KEYS = ("fused_read_tile", "reduce_tiles", "read_prepare", "tc_range",
             "tc_read")
#: The VLM's cross-block gates on the card (the tests' values).  The
#: reference starts them at 0, where ``tanh(0)`` hides each cross block's
#: output and gives its containers zero cotangents.
CROSS_GATES = {"gate_attn": 0.5, "gate_ffn": 0.75}


def set_cross_gates(params, cfg):
    """Every cross block's gates in ``params`` set to ``CROSS_GATES``, in
    place; fails if a VLM tree has none."""
    n = 0
    with torch.no_grad():
        for path, v in tree_leaves(params):
            if path[-1] in CROSS_GATES:
                v.fill_(CROSS_GATES[path[-1]])
                n += v.numel()
    if cfg.family == "vlm" and n != 2 * (cfg.n_layers // cfg.cross_attn_every):
        fail(f"{cfg.name}: {n} cross gates set")


def stream_extras(cfg, b, seed):
    """The stub frontend's stream of ``cfg``, seeded normals on the card:
    ``{"audio": (b, n_audio_frames, d)}`` or ``{"vision": (b,
    n_vision_tokens, d)}``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    key, n = ("audio", cfg.n_audio_frames) if cfg.family == "audio" \
        else ("vision", cfg.n_vision_tokens)
    return {key: torch.randn((b, n, cfg.d_model), generator=gen,
                             device="cuda")}


def call_rows(params, cfg, b, s, decode):
    """The operand rows of each read one model call over ``b`` x ``s``
    tokens makes (in no order): each crossbar (or fakequant) matrix once a
    layer and once an application (``analog_registry.tape_reps``: the
    hybrid's shared block once a group), over
    ``analog_registry.operand_rows`` (the audio encoder's the frames, the
    cross ``wqkv``'s both streams).  An audio decode step reads no encoder
    matrix and drives its cross ``wqkv`` with the token alone (the cross
    keys and values are cached); the VLM's re-reads the whole stream."""
    from repro_torch.core.analog_registry import operand_rows, tape_reps
    rows = []
    for path, v in tree_leaves(params):
        if not crossbar_leaf(path):
            continue
        r = operand_rows(path, cfg, b * s, (b, s))
        if decode and cfg.family == "audio":
            if path[0] == "enc_layers":
                continue
            r = b * s
        rows += [r] * (math.prod(v.shape[:-2]) * tape_reps(path, cfg))
    return rows


def reckon(M, cfg, train_shape=None):
    """Bytes a phase will hold, from a meta-device tree (nothing
    allocated): crossbar cells and digital float32 elements; served from
    crossbars 16 bytes a cell (``g``, ``ref`` and the engine's
    ``g_target`` of each) plus the digital leaves; in fakequant mode 4
    bytes an element; a training step (``train_shape`` (B, S)) ``g`` and
    ``ref``, a new ``g``, the digital leaves three times (leaf, new leaf,
    and a gradient or the update's temporary: each gradient is freed once
    its leaf is written), the tapes, and for the audio encoder each
    layer's saved softmax (B x heads x frames^2)."""
    from repro_torch.core.analog_registry import operand_rows
    params = M.init_params(cfg.digital(), torch.Generator(), device="meta")
    cells = digital = tapes = 0
    for path, v in tree_leaves(params):
        if crossbar_leaf(path):
            cells += v.numel()
            if train_shape is not None:
                bb, s = train_shape
                rows = operand_rows(path, cfg, bb * s, (bb, s))
                tapes += 4 * math.prod(v.shape[:-2]) * rows * sum(
                    v.shape[-2:])
        else:
            digital += v.numel()
    out = {"cells": cells, "digital_elements": digital}
    if train_shape is None:
        out["crossbar_gb"] = 16 * cells / 1e9
        out["fakequant_gb"] = 4 * (cells + digital) / 1e9
        out["digital_gb"] = 4 * digital / 1e9
    else:
        bb = train_shape[0]
        attn = 4 * cfg.n_encoder_layers * bb * cfg.n_heads \
            * cfg.n_audio_frames ** 2
        out.update(tapes_gb=tapes / 1e9, encoder_softmax_gb=attn / 1e9,
                   step_peak_gb=(12 * cells + 12 * digital + tapes + attn)
                   / 1e9)
    return out


def static_serve(K, engine, cfg, prompts, sp, what, OPS=None):
    """One static-scheduler ``generate`` (a left-padded prefill, then
    ``max_new_tokens - 1`` decode calls) with the counts set to 0 just
    before and read just after: crossbar reads, or fakequant reads where
    ``OPS`` (``kernels.ops``) is given.  Gates: the reads ``call_rows``
    gives, each on the instance its rows pick (``read_instance`` or
    ``fakequant_instance``) with every kernel of that instance launched
    once (the FP32 crossbar read's K-order sum too: every K spans several
    64-row tiles); no transpose read; no plain version of the fakequant
    read; full outputs in the vocabulary."""
    from repro_torch.core import AdcConfig
    fakequant = OPS is not None
    if engine.supports_continuous:
        fail(f"{what}: the engine offers the continuous scheduler")
    lv = AdcConfig(in_bits=cfg.analog_in_bits).in_levels
    pick = K.fakequant_instance if fakequant else K.read_instance
    b, plen = len(prompts), max(len(p) for p in prompts)
    pre = [pick(r, lv) for r in call_rows(engine.params, cfg, b, plen,
                                          False)]
    dec = [pick(r, lv) for r in call_rows(engine.params, cfg, b, 1, True)]
    calls = sp.max_new_tokens
    inst = pre + dec * (calls - 1)
    tc = inst.count("tensor_core")
    fp = len(inst) - tc
    if fakequant:
        want = {"fakequant_scale_kernel": fp, "fakequant_prepare_kernel": tc,
                "fakequant_fp32_kernel": fp, "fakequant_tc_kernel": tc,
                "fakequant_epilogue_kernel": len(inst)}
    else:
        want = {"fused_read_tile_kernel": fp, "reduce_tiles_kernel": fp,
                "read_prepare_kernel": tc, "tc_range_kernel": tc,
                "tc_read_kernel": tc}
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    plain_calls = []
    counting = counting_plain(K, OPS, plain_calls) if fakequant \
        else contextlib.nullcontext()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting:
        outs = engine.generate(prompts, sp)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = dict(K.LAUNCHES)
    if fakequant:
        reads, other = n["fakequant"], n["fused_vmm"] + n["fused_mvm"]
        by_kernel = {name: n[c] for name, c in FQ_KERNELS.items()}
    else:
        reads, other = n["fused_vmm"], n["fused_mvm"] + n["fakequant"]
        by_kernel = read_kernel_launches([n], "vmm")
    if reads != len(inst) or by_kernel != want or other or plain_calls:
        fail(f"{what}: {reads} reads in {calls} calls, launches {by_kernel}, "
             f"{other} other reads, {len(plain_calls)} plain-version calls; "
             f"expected {len(pre)} in the prefill and {len(dec)} a decode "
             f"call, {want}")
    if [len(o) for o in outs] != [sp.max_new_tokens] * len(prompts) or \
            not all(0 <= t < cfg.vocab for o in outs for t in o):
        fail(f"{what}: bad outputs {outs}")
    n_tok = sum(len(o) for o in outs)
    return outs, {"tokens": n_tok, "seconds": dt, "tokens_per_s": n_tok / dt,
                  "model_calls": calls, "reads": reads,
                  "reads_prefill": len(pre), "reads_per_decode_call": len(dec),
                  "tensor_core_reads": tc, "launches_by_kernel": by_kernel,
                  "plain_calls": len(plain_calls)}


def cross_probe(K, M, TT, TMoE, OPS, cfg, params, prompts, extras, what,
                fakequant):
    """A left-padded prefill of ``prompts`` with the stream and one decode
    step, every read recorded: the reads' rows as ``call_rows``
    gives them (an audio decode step reading no encoder matrix), each held
    against its plain version on the card on its own operands (phase 1's
    bound, or phase 8's for fakequant reads; DAC scales bit-equal), and
    both calls' logits against a CPU run with the card's reads replayed,
    within 1e-3."""
    toks = left_padded(prompts)
    b, plen = toks.shape
    rec = []
    recording = recording_fq(K, rec) if fakequant else recording_reads(K,
                                                                       rec)
    with torch.no_grad(), recording:
        logits, cache = M.prefill(params, {"tokens": toks, **extras}, cfg,
                                  64)
        n_pre = len(rec)
        tok = logits.argmax(-1)
        logits_dec, _ = M.decode_step(params, cache, tok, cfg, extras)
    torch.cuda.synchronize()

    def rows(r):
        return math.prod(r[0].shape[:-1])
    got = (sorted(rows(r) for r in rec[:n_pre]),
           sorted(rows(r) for r in rec[n_pre:]))
    want = (sorted(call_rows(params, cfg, b, plen, False)),
            sorted(call_rows(params, cfg, b, 1, True)))
    if got != want:
        fail(f"{what}: reads over {got} rows in a prefill and a decode step; "
             f"expected {want}")
    encoder = {v.untyped_storage().data_ptr()
               for path, v in tree_leaves(params)
               if path[0] == "enc_layers" and crossbar_leaf(path)}
    if any(r[1].untyped_storage().data_ptr() in encoder
           for r in rec[n_pre:]):
        fail(f"{what}: a decode step read an encoder matrix")
    worst = check_fq_reads(K, rec, what) if fakequant \
        else check_reads(K, rec, where="cuda")
    worst["reads_checked"] = len(rec)
    cpu_params = meta_containers(params, crossbar_leaf) if fakequant \
        else meta_containers(params)
    cpu_extras = {k: v.cpu() for k, v in extras.items()}

    def run(p):
        first, c = M.prefill(p, {"tokens": toks.cpu(), **cpu_extras}, cfg,
                             64)
        return first, M.decode_step(p, c, tok.cpu(), cfg, cpu_extras)[0]
    (cpu_pre, cpu_dec), _ = moe_replay_cpu(
        M, TT, TMoE, cfg, cpu_params, toks, rec, [], run=run,
        OPS=OPS if fakequant else None)
    del cpu_params, rec
    d_pre = (logits.cpu() - cpu_pre).abs().max().item()
    d_dec = (logits_dec.cpu() - cpu_dec).abs().max().item()
    if not (d_pre <= 1e-3 and d_dec <= 1e-3):
        fail(f"{what}: card and CPU logits differ with the reads replayed: "
             f"prefill {d_pre}, decode {d_dec} (bound 1e-3)")
    return worst, {"replay_max_abs_logit_diff_prefill": d_pre,
                   "replay_max_abs_logit_diff_decode": d_dec,
                   "max_abs_logit": logits.abs().max().item()}


def decode_read_spans(K, M, cfg, params, extras, max_len=32, lead=None):
    """CUDA-event time of each crossbar read of one decode step (B = 4,
    after a 12-token prefill and one decode step; the events around each
    launch of the read, its kernels back to back on the stream; with
    ``lead``, only the reads of matrices with that lead dim, as an expert
    stack's), summed by instance, beside the reads' g + ref bytes at the
    HBM rate and, on the tensor cores, the products' floor (three bf16
    passes at 989 TFLOP/s)."""
    read_cuda = K._read_cuda
    spans = []

    def timed(x, g, ref, sc, xcfg, transpose=False):
        if lead is not None and g.shape[0] != lead:
            return read_cuda(x, g, ref, sc, xcfg, transpose)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        y = read_cuda(x, g, ref, sc, xcfg, transpose)
        b.record()
        spans.append((a, b, x.shape[1], g, K.read_instance(
            x.shape[1], xcfg.adc.in_levels)))
        return y
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 12))).cuda()
    with torch.no_grad():
        logits, cache = M.prefill(params, {"tokens": toks, **extras}, cfg,
                                  max_len)
        logits, cache = M.decode_step(params, cache, logits.argmax(-1), cfg,
                                      extras)
        K._read_cuda = timed
        try:
            M.decode_step(params, cache, logits.argmax(-1), cfg, extras)
        finally:
            K._read_cuda = read_cuda
        torch.cuda.synchronize()
    out = {}
    for a, b, rows, g, inst in spans:
        d = out.setdefault(inst, {"reads": 0, "rows": sorted({rows}),
                                  "ms": 0.0, "bytes": 0, "flops": 0})
        d["reads"] += 1
        d["rows"] = sorted(set(d["rows"]) | {rows})
        d["ms"] += a.elapsed_time(b)
        d["bytes"] += 8 * g.numel()
        d["flops"] += 2 * rows * g.numel()
    for inst, d in out.items():
        d["bound_ms"] = 1e3 * d["bytes"] / HBM_BYTES_PER_S
        if inst == "tensor_core":
            d["tc_floor_ms"] = max(d["bound_ms"],
                                   1e3 * 3 * d["flops"] / BF16_FLOPS)
            d["fp32_bound_ms"] = max(d["bound_ms"],
                                     1e3 * d["flops"] / FP32_FLOPS)
    return out


def phase_cross_serve(M, K, TT, TMoE, OPS, make_engine, SamplingParams,
                      get_config, arch, n_layers, report, label):
    """Phase 22(a) / 23(a): ``arch`` from ``taox-nonoise`` 64x64 crossbars
    (at ``n_layers`` where cut), served by the static scheduler with its
    stream (see the module docstring)."""
    torch.cuda.empty_cache()
    full = get_config(arch)
    cfg = device_serve_cfg(full, n_layers)
    need = reckon(M, cfg)
    print(f"phase {label}: {arch} at {cfg.n_layers} of {full.n_layers} "
          f"layers: {need['cells'] / 1e9:.4f} B cells, reckoned "
          f"{need['crossbar_gb'] + need['digital_gb']:.1f} GB resident "
          f"({need['crossbar_gb']:.1f} of g, ref and g_target, "
          f"{need['digital_gb']:.1f} digital)")
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    extras = stream_extras(cfg, 4, 22)
    t0 = time.perf_counter()
    params = program_model(M, cfg)
    set_cross_gates(params, cfg)
    engine = make_engine(cfg, params, backend="analog", max_len=64,
                         extras=extras)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    params = engine.params
    resident_gb = torch.cuda.memory_allocated() / 1e9
    print(f"phase {label}: programmed in {program_s:.1f} s, "
          f"{resident_gb:.2f} GB resident ({start_gb:.2f} GB allocated "
          "before)")
    prompts = dense_prompts(cfg, 4)
    engine.generate(prompts, SamplingParams(max_new_tokens=2))  # warm-up
    _, serve = static_serve(K, engine, cfg, prompts,
                            SamplingParams(max_new_tokens=16),
                            f"{arch} serve")
    worst, replay = cross_probe(K, M, TT, TMoE, OPS, cfg, params, prompts,
                                extras, arch, False)
    profile = profile_decode_step(M, cfg, params, "crossbar", READ_KEYS,
                                  extras=extras)
    spans = decode_read_spans(K, M, cfg, params, extras)
    energy = engine.energy_per_token()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cut = f"{cfg.n_layers} of {full.n_layers} layers, full widths" \
        if n_layers else "none: full size"
    res = {"config": arch, "cut": cut, "reckoned": need,
           "program_s": program_s, "resident_gb": resident_gb,
           "allocated_before_gb": start_gb, "serve": serve,
           "probe_reads": worst, **replay, "decode_profile": profile,
           "decode_reads_by_instance": spans, "peak_memory_gb": peak_gb,
           "energy_per_token": energy}
    report(res)
    fp, tc = spans.get("fp32", {}), spans.get("tensor_core")
    cross = "" if tc is None else (
        f"; the cross wqkv read ({tc['rows']} rows, tensor cores) "
        f"{tc['ms']:.2f} ms (floor {tc['tc_floor_ms']:.2f})")
    print(f"phase {label}: {arch} ({cut}) served "
          f"{serve['tokens_per_s']:.1f} tokens/s from crossbars, static "
          f"scheduler ({serve['reads']} reads: {serve['reads_prefill']} in "
          f"the prefill, {serve['reads_per_decode_call']} a decode call; "
          f"{serve['tensor_core_reads']} on the tensor cores); "
          f"{worst['reads_checked']} probe reads agree "
          f"({worst['max_err_over_bound']:.3f} of the bound); replayed CPU "
          f"logits {replay['replay_max_abs_logit_diff_prefill']:.3g} / "
          f"{replay['replay_max_abs_logit_diff_decode']:.3g} off; decode "
          f"step device {profile.get('device_ms') or 0:.2f} ms; its "
          f"{fp.get('reads', 0)} FP32 reads {fp.get('ms', 0):.2f} ms "
          f"(events) for {fp.get('bytes', 0) / 1e9:.2f} GB (bound "
          f"{fp.get('bound_ms', 0):.2f} ms){cross}; resident "
          f"{resident_gb:.2f} GB, peak {peak_gb:.2f} GB")
    del engine, params
    return res


def phase_cross_fq_serve(M, K, TT, TMoE, OPS, make_engine, SamplingParams,
                         get_config, arch, n_layers, report, label):
    """Phase 22(b) / 23(b): ``arch`` in fakequant mode (1024-row tiles,
    8-bit, random weights from torch.Generator seed 0, at ``n_layers``
    where cut), served by the static scheduler with its stream."""
    torch.cuda.empty_cache()
    full = get_config(arch)
    cfg = cut_depth(full.replace(dtype="float32", analog=True,
                                 analog_mode="fakequant"), n_layers)
    need = reckon(M, cfg)
    print(f"phase {label}: {arch} in fakequant mode at {cfg.n_layers} of "
          f"{full.n_layers} layers: reckoned {need['fakequant_gb']:.1f} GB "
          "of float32 weights")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = M.init_params(cfg, gen, device="cuda")
    set_cross_gates(params, cfg)
    extras = stream_extras(cfg, 4, 22)
    engine = make_engine(cfg, params, max_len=64, extras=extras)
    prompts = dense_prompts(cfg, 4)
    engine.generate(prompts, SamplingParams(max_new_tokens=2))
    _, serve = static_serve(K, engine, cfg, prompts,
                            SamplingParams(max_new_tokens=16),
                            f"{arch} fakequant serve", OPS)
    worst, replay = cross_probe(K, M, TT, TMoE, OPS, cfg, params, prompts,
                                extras, f"{arch} fakequant", True)
    profile = profile_decode_step(M, cfg, params, extras=extras)
    cut = f"{cfg.n_layers} of {full.n_layers} layers, full widths" \
        if n_layers else "none: full size"
    res = {"config": arch, "cut": cut, "reckoned": need, "serve": serve,
           "probe": worst, **replay, "profile": profile,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    report(res)
    print(f"phase {label}: {arch} fakequant ({cut}) served "
          f"{serve['tokens_per_s']:.1f} tokens/s ({serve['reads']} reads, "
          f"{serve['tensor_core_reads']} on the tensor-core instance, one "
          f"launch of each of its kernels a read; no plain version); "
          f"probe reads agree ({worst['max_err_over_bound']:.3f} of the "
          f"bound); replayed CPU logits "
          f"{replay['replay_max_abs_logit_diff_prefill']:.3g} / "
          f"{replay['replay_max_abs_logit_diff_decode']:.3g} off; decode "
          f"step device {profile.get('device_ms') or 0:.2f} ms; peak "
          f"{res['peak_memory_gb']:.2f} GB")
    del engine, params
    return res


def phase_cross_train(K, U, TA, M, syn, get_config, report, arch, n_layers,
                      label):
    """Phase 22(c) / 23(c): one device-mode training step of ``arch`` (at
    ``n_layers`` where cut): TaOx, 64x64 tiles, lr 0.1, the tokens and
    stream of ``CROSS_TRAIN_SHAPE`` (see the module docstring)."""
    from repro_torch.core.analog_registry import container_paths, operand_rows
    torch.cuda.empty_cache()
    full = get_config(arch)
    cfg = full.replace(dtype="float32", analog=True, analog_mode="device",
                       analog_device="taox", analog_rows=64, analog_cols=64)
    cfg = cut_depth(cfg, n_layers)
    b, s = CROSS_TRAIN_SHAPE[arch]
    need = reckon(M, cfg, train_shape=(b, s))
    print(f"phase {label}: {arch} step at {cfg.n_layers} of "
          f"{full.n_layers} layers, {b} x {s} tokens: reckoned peak "
          f"{need['step_peak_gb']:.1f} GB (tapes {need['tapes_gb']:.1f}, "
          f"the encoder's saved softmax {need['encoder_softmax_gb']:.1f})")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    state = TA.init_state(gen, cfg, device="cuda")
    set_cross_gates(state["params"], cfg)
    step = TA.make_analog_sgd_step(cfg, lr=0.1)
    stream = syn.make_token_stream(200_000, cfg.vocab, seed=0)
    x, y = syn.batch_tokens(stream, b, s, 0)
    extras = stream_extras(cfg, b, 23)
    batch = {"tokens": torch.from_numpy(x).long().cuda(),
             "labels": torch.from_numpy(y).long().cuda(), **extras}
    paths = container_paths(state["params"])
    n_reads = ssm_reads(state["params"], cfg)
    n_cont = len(paths)
    expect = tensor_core_train_expect(
        0, fakequant=0, **dict.fromkeys(FQ_KERNELS.values(), 0),
        outer_update=n_cont, pulse_update=0, update_tc=n_cont,
        update_prepare=n_cont, update_fp32=0)
    for d in ("vmm", "mvm"):
        for c in READ_KERNEL_COUNTS.values():
            if c not in ("read_tile", "reduce_tiles"):
                expect[f"{c}_{d}"] = n_reads
        expect[f"fused_{d}"] = n_reads
    name = f"{arch} train step"
    reads, writes, tape_rows, d_tape_max = [], [], {}, {}
    update_cuda = U._update_cuda
    update_container = TA.AnalogTrainStep._update_container

    def recorded_write(*args, **kw):
        out = update_cuda(*args, **kw)
        # the old and the new conductances stay as they are until the
        # check after the step: no copy of either
        writes.append((write_call(update_cuda, args, kw), out))
        return out

    def rows_checked(self, p, tapes, seed_base, path, rail):
        """Each container's tape: one block a layer of the operand rows
        ``operand_rows`` gives (the encoder's the frames, the cross
        ``wqkv``'s the tokens and the stream), and a cotangent that is not
        zero in any layer (the cross blocks' gates are set)."""
        lead, (k, n) = p["g"].shape[:-2], p["g"].shape[-2:]
        rows = operand_rows(path, cfg, b * s, (b, s))
        if tuple(tapes["x_tape"].shape) != (*lead, rows, k) \
                or tuple(tapes["d_tape"].shape) != (*lead, rows, n):
            fail(f"{name}: {path} tapes {tuple(tapes['x_tape'].shape)} / "
                 f"{tuple(tapes['d_tape'].shape)}; expected {rows} rows a "
                 "layer")
        d_max = tapes["d_tape"].abs().flatten(len(lead)).amax(-1)
        if not bool((d_max > 0).all()):
            fail(f"{name}: {path} has an all-zero cotangent in layers "
                 f"{(d_max == 0).nonzero().flatten().tolist()}")
        tape_rows["/".join(path)] = rows
        d_tape_max["/".join(path)] = d_max.min().item()
        return update_container(self, p, tapes, seed_base, path, rail)
    U._update_cuda = recorded_write
    TA.AnalogTrainStep._update_container = rows_checked
    reset_launches(K, U)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with recording_reads(K, reads, host=True):
            state, mets = step(state, batch, 12345)
            torch.cuda.synchronize()
    finally:
        U._update_cuda = update_cuda
        TA.AnalogTrainStep._update_container = update_container
    step_ms = 1e3 * (time.perf_counter() - t0)
    peak_step_gb = torch.cuda.max_memory_allocated() / 1e9
    got = {**K.LAUNCHES, **U.LAUNCHES}
    if got != expect or len(tape_rows) != n_cont:
        fail(f"{name} launched {got}, saw {len(tape_rows)} containers' "
             f"tapes; expected {expect} and {n_cont}")
    loss = float(mets["loss"])
    if not math.isfinite(loss):
        fail(f"{name}: loss {loss}")
    worst_w = check_writes(U, writes, name)
    del writes
    worst_r = check_reads(K, reads, where="cuda")
    n_checked = len(reads)
    del reads
    if worst_r["zero_leads"]:
        fail(f"{name}: {worst_r['zero_leads']} reads of all-zero operands")
    for path, g in tree_leaves(state["params"]):
        if path[-1] == "g" and not (g.min() >= 0 and g.max() <= 1):
            fail(f"{arch}: conductances of {path} left the window")
    torch.cuda.reset_peak_memory_stats()
    prof = profile_train_step(K, U, syn, step, state, stream, gen, expect,
                              shape=(b, s), extras=extras)
    peak_bare_gb = torch.cuda.max_memory_allocated() / 1e9
    cut = f"{cfg.n_layers} of {full.n_layers} layers, full widths (the " \
        "training step only)" if n_layers else "none: full depth"
    res = {"config": arch, "cut": cut, "tokens": [b, s],
           "stream_rows": b * (cfg.n_audio_frames or cfg.n_vision_tokens),
           "reckoned": need, "loss": loss, "step_ms_recorded": step_ms,
           "launches": got, "tape_rows": tape_rows,
           "d_tape_min_layer_max": d_tape_max, "reads_checked": n_checked,
           **{f"reads_{k}": v for k, v in worst_r.items()},
           **{f"writes_{k}": v for k, v in worst_w.items()},
           "profile": prof, "peak_step_memory_gb": peak_step_gb,
           "peak_profiled_step_memory_gb": peak_bare_gb}
    report(res)
    by = prof["device_ms_by_group"]
    print(f"phase {label}: {arch} ({cut}) one device-mode step, {b} x {s} "
          f"tokens with {res['stream_rows']} stream rows: loss {loss:.5f}; "
          f"{n_checked} reads ({worst_r['max_err_over_bound']:.3f} of the "
          f"bound) and {n_cont} tensor-core writes "
          f"({worst_w['max_err_over_twin_bound']:.3f} of the twin's bound) "
          f"agree with their plain versions; tape rows {tape_rows}; "
          f"profiled step: reads "
          f"{by['forward reads'] + by['transpose reads']:.1f} ms, "
          f"pre-passes {by['read pre-passes'] + by['write pre-passes']:.1f}, "
          f"writes {by['rank-k writes']:.1f}, digital ops "
          f"{by['other (digital ops)']:.1f}; peak {peak_step_gb:.2f} GB in "
          f"the recorded step, {peak_bare_gb:.2f} GB in the profiled one")
    del state
    return res


# --------------------------------------------------------------------------
# Phase 24: the sharded step's kernel work on one card
# --------------------------------------------------------------------------

#: The tile layouts (data x model) phase 24 cuts lm100m's containers into.
SHARD_LAYOUTS = ((2, 4), (4, 4))
SHARD_T = 2048                    # tokens of a training step's write
SHARD_READ_B = (4, 2048)          # FP32-instance and tensor-core reads
SHARD_EXPERT_LAYOUT = (1, 4)      # llama4-scout's experts over 4 shards
SHARD_EXPERT_ARCH = "llama4-scout-17b-a16e"
#: 24(b)'s times: CUDA events (host included) of the whole read and of
#: the emulated layout's reads, and the profiler's kernel time of the
#: latter.
SHARD_READ_TIMES = ("ms", "sharded_ms", "sharded_device_ms")
SHARD_CLI_STEPS = 6
SHARD_CLI_RESUME = 4
SHARD_CLI_SEQ, SHARD_CLI_BATCH = 256, 8
SHARD_CLI_FREE_BYTES = 24e9       # lm100m's QAT step at 8 x 256 tokens


def layout_blocks(TM, S, path, g_shape, mcfg, layout):
    """Every rank's block of a container under ``layout``, in flat rank
    order: (coords, the rank's specs, its slices of ``g``, its mesh)."""
    axes = ("data", "model")
    out = []
    for coords in TM.layout_coords(TM.emulated_mesh(layout, axes)):
        m = TM.emulated_mesh(layout, axes, coords)
        specs = S.analog_update_specs(path, g_shape, mcfg, m)
        out.append((coords, specs, S.block_slices(g_shape, specs["g"], m),
                    m))
    return out


def block_write_ok(U, blk, out, offs, seed, cfg, xs, ds):
    """One block written at its offsets against its plain versions at the
    same offsets: ``tc_write_agrees`` (tensor cores, with the container's
    code scales) or ``update_bound`` / ``pulse_agrees`` (FP32).  Returns
    (ok, share of cells on an allowance)."""
    g, x_q, d_q, scale = blk
    g_p = U._update_plain(g, x_q, d_q, scale, None, seed, cfg, "kernel",
                          offs)
    z = U.field_normals(seed, g.shape, cfg, offs, device=g.device)
    if xs is not None:
        g_x = U._update_tc_plain(g, x_q, d_q, scale, None, seed, cfg,
                                 "kernel", xs, ds, offs)
        ok, _, _, share = tc_write_agrees(out, g_p, g_x, g, x_q, d_q, scale,
                                          cfg, z)
        return ok and share < SUM_TIE_SHARE, share
    if cfg.update_mode == "pulse_train":
        ok, _, _, share = pulse_agrees(out, g_p, g, x_q, d_q, scale, cfg, z)
        return ok, share
    return bool(((out - g_p).abs() <= update_bound(g_p, g)).all()), 0.0


def offsets_case(U, g3, x3, d3, scale, xs, ds, blocks, cfg, seed, label):
    """Phase 24(a) on one flattened (L, K, N) container: the whole write,
    then every block alone at its (layer, row-tile, col-tile) offsets
    (``blocks``: (lead slice, row slice, col slice) per rank), reassembled
    and held bit-equal to the whole write, each block also against its
    plain versions.  Counts each instance's launches.  Returns the row."""
    sync = torch.cuda.synchronize
    scaled = xs is not None
    before = dict(U.LAUNCHES)
    whole = U._update_cuda(g3, x3, d3, scale, None, seed, cfg, "kernel", xs,
                           ds)
    joined = torch.empty_like(whole)
    worst = 0.0
    for lsl, ksl, nsl in blocks:
        blk = (g3[lsl, ksl, nsl].contiguous(), x3[lsl, :, ksl].contiguous(),
               d3[lsl, :, nsl].contiguous(), scale[lsl].contiguous())
        bxs = xs[lsl].contiguous() if scaled else None
        bds = ds[lsl].contiguous() if scaled else None
        offs = (lsl.start or 0, (ksl.start or 0) // cfg.rows,
                (nsl.start or 0) // cfg.cols)
        out = U._update_cuda(*blk, None, seed, cfg, "kernel", bxs, bds, offs)
        joined[lsl, ksl, nsl] = out
        ok, share = block_write_ok(U, blk, out, offs, seed, cfg, bxs, bds)
        worst = max(worst, share)
        if not ok:
            fail(f"24(a) {label}: block {offs} disagrees with its plain "
                 f"versions at its offsets")
        del blk, out
    sync()
    n = len(blocks) + 1
    launched = {k: U.LAUNCHES[k] - before[k] for k in U.LAUNCHES}
    want = {"update_tc": n if scaled else 0,
            "update_prepare": n if scaled else 0,
            "update_fp32": 0 if scaled else n}
    if any(launched[k] != v for k, v in want.items()):
        fail(f"24(a) {label}: launches {launched}, expected {want}")
    equal = torch.equal(joined, whole)
    # the first tile written as if it were tile (1, 1): other noise
    shifted = (whole[:, :cfg.rows, :cfg.cols] - U._update_cuda(
        g3[:, :cfg.rows, :cfg.cols].contiguous(),
        x3[:, :, :cfg.rows].contiguous(), d3[:, :, :cfg.cols].contiguous(),
        scale, None, seed, cfg, "kernel", xs, ds, (0, 1, 1))
               ).abs().max().item()
    row = {"case": label, "shape": list(g3.shape), "T": x3.shape[1],
           "blocks": len(blocks), "instance":
           "tensor_core" if scaled else "fp32", "mode": cfg.update_mode,
           "bit_equal": equal, "allowance_share_max": worst,
           "launches": launched,
           "wrong_offset_moves": shifted}
    if not equal:
        fail(f"24(a) {label}: the blocks written at their offsets are not "
             f"bit-equal to the whole write")
    # (outer mode: every requested cell draws noise; a pulse-train cell
    # only with an event)
    if cfg.update_mode == "outer" and shifted <= 0.0:
        fail(f"24(a) {label}: a block at other offsets drew the same noise")
    del whole, joined
    return row


def phase_shard_writes(U, S, TM, TAOX, CrossbarConfig, get_config, report):
    """24(a): lm100m's four containers at full width, (12, K, N) with T =
    2048 and TaOx counter-PRNG noise, cut into the policy's blocks on 2x4
    and 4x4 layouts, and one llama4-scout-17b-a16e expert stack (1 layer,
    its 16 experts over 4 shards): each block written alone at its
    offsets, on both instances in both update modes, bit-equal to the
    whole write."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    mcfg = get_config("lm100m").replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox", analog_rows=64, analog_cols=64)
    rows = []
    seed = 0x2545F491
    for name, k, n in TRAIN_SHAPES:
        g, x_q, d_q, scale, xs, ds = update_operands(12, k, n, SHARD_T, gen,
                                                     False)
        path = ("layers", "ffn" if name.startswith("w_") else "attn", name)
        for layout in SHARD_LAYOUTS:
            blocks = [(slice(None), sl[-2], sl[-1]) for _, _, sl, _ in
                      layout_blocks(TM, S, path, tuple(g.shape), mcfg,
                                    layout)]
            for mode in ("outer", "pulse_train"):
                cfg = CrossbarConfig(rows=64, cols=64, device=TAOX,
                                     update_mode=mode)
                for scaled in (True, False):
                    label = (f"{name} {layout[0]}x{layout[1]} {mode} "
                             f"{'tc' if scaled else 'fp32'}")
                    row = offsets_case(U, g, x_q, d_q, scale,
                                       xs if scaled else None,
                                       ds if scaled else None, blocks, cfg,
                                       seed, label)
                    rows.append(row)
                    report(row)
        del g, x_q, d_q
    ecfg = get_config(SHARD_EXPERT_ARCH)
    e, k, n = ecfg.n_experts, ecfg.d_model, ecfg.d_ff_expert or ecfg.d_ff
    cap = -(-int(1.25 * SHARD_T * ecfg.top_k) // e)
    cap = max(8, -(-cap // 8) * 8)
    g, x_q, d_q, scale, xs, ds = update_operands(e, k, n, cap, gen, False)
    m0 = TM.emulated_mesh(SHARD_EXPERT_LAYOUT, ("data", "model"))
    xcfg = get_config(SHARD_EXPERT_ARCH).replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox")
    path = ("layers", "moe", "experts", "w_up")
    blocks = []
    for coords in TM.layout_coords(m0):
        m = TM.emulated_mesh(SHARD_EXPERT_LAYOUT, ("data", "model"), coords)
        spec = S.analog_update_specs(path, (1, e, k, n), xcfg, m)["g"]
        sl = S.block_slices((1, e, k, n), spec, m)
        if spec[1] != ("model",):
            fail(f"24(a): the expert dim is not over model: {spec}")
        # the registry hoists the expert dim outermost: at one layer the
        # flattened lead index is the expert index
        blocks.append((sl[1], sl[2], sl[3]))
    for mode in ("outer", "pulse_train"):
        cfg = CrossbarConfig(rows=xcfg.analog_rows, cols=xcfg.analog_cols,
                             device=TAOX, update_mode=mode)
        for scaled in (True, False):
            label = (f"expert w_up (E {e}) 1x4 {mode} "
                     f"{'tc' if scaled else 'fp32'}")
            row = offsets_case(U, g, x_q, d_q, scale, xs if scaled else None,
                               ds if scaled else None, blocks, cfg, seed,
                               label)
            rows.append(row)
            report(row)
    del g, x_q, d_q
    print(f"phase 24(a): {len(rows)} block-write cases bit-equal to the "
          f"whole write ({sum(r['blocks'] for r in rows)} blocks at their "
          f"offsets, each within its plain versions' gates)")
    return rows


def shard_read_case(K, S, TM, path, x, g, ref, ws, cfg, mcfg, layout,
                    transpose, label):
    """24(b) for one container, layout and direction: every rank of the
    layout, emulated one after another on the card
    (``launch.mesh.emulate_layout``), runs the sharded step's read,
    ``kernels.xbar_vmm.manual_collective_read``, on its block of the
    container and the whole replicated drive: the DAC scale of its
    matrices' whole drives, its tiles read in partials form where the
    reduction dim is split, the partials gathered in tile order over the
    reduction shards by ``core.shardctx.combine_partials_exact`` and
    summed by ``reduce_tiles_kernel``, the output and expert blocks
    gathered.  Each rank's result is bit-equal to the whole read.  Times
    both on the card with CUDA events around the call (the emulated
    layout's is every rank's work one after another, its host time
    included), and the emulated layout's kernel time from torch.profiler
    (``device_ms``: the host's rank hand-overs left out)."""
    sync = torch.cuda.synchronize
    axes = ("data", "model")
    shape = tuple(g.shape)
    whole = K.xbar_fused_read(x, g, ref, ws, cfg, transpose=transpose)
    blocks = {}
    for coords in TM.layout_coords(TM.emulated_mesh(layout, axes)):
        m = TM.emulated_mesh(layout, axes, coords)
        spec = S.analog_update_specs(path, shape, mcfg, m)["g"]
        sl = S.block_slices(shape, spec, m)
        blocks[m.rank] = (g[sl].contiguous(), ref[sl].contiguous(),
                          ws[sl[:-2]].contiguous(),
                          S.shard_meta(shape, spec, m))
    meta = blocks[0][3]
    if meta is None:
        fail(f"24(b) {label}: the policy splits no dim of {shape}")
    red_names = meta.col if transpose else meta.row

    def rank_read(m):
        gb, rb, wb, mt = blocks[m.rank]
        return K.manual_collective_read(x, gb, rb, wb, cfg, mt,
                                        transpose=transpose, mesh=m)

    def sharded(i=0):
        return TM.emulate_layout(layout, axes, rank_read)
    d = "mvm" if transpose else "vmm"
    before = dict(K.LAUNCHES)
    ys = sharded()
    sync()
    launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                if K.LAUNCHES[k] != before[k]}
    n = len(blocks)
    want_reduce = n if red_names else 0
    if launched.get(f"fused_{d}", 0) != n \
            or launched.get(f"reduce_tiles_{d}", 0) != want_reduce:
        fail(f"24(b) {label}: launches {launched}, expected {n} reads and "
             f"{want_reduce} tile sums")
    equal = all(torch.equal(y, whole) for y in ys)
    if not equal:
        worst = max((y - whole).abs().max().item() for y in ys)
        fail(f"24(b) {label}: the shard-local reads are not bit-equal to "
             f"the whole read (max diff {worst:.3g})")
    del ys
    def whole_read(i=0):
        return K.xbar_fused_read(x, g, ref, ws, cfg, transpose=transpose)
    row = {"case": label, "B": x.shape[-2], "transpose": transpose,
           "expert": len(shape) > 3,
           "instance": K.read_instance(x.shape[-2], cfg.adc.in_levels),
           "shards": n, "partials_form": bool(red_names),
           "bit_equal": equal, "launches": launched,
           "ms": cuda_ms(whole_read, 3, sync),
           "sharded_ms": cuda_ms(sharded, 3, sync),
           "sharded_device_ms": device_ms(sharded, 3)}
    row["sharded_ms_per_shard"] = row["sharded_ms"] / n
    return row


def phase_shard_reads(K, S, TM, CrossbarConfig, AdcConfig, TAOX_NONOISE,
                      get_config, gpu_line, report):
    """24(b): the same containers and layouts, forward and transpose, at
    B = 4 (FP32 instance) and B = 2048 (tensor cores), and one
    llama4-scout-17b-a16e expert stack (1 layer, its 16 experts over 4
    shards, at a capacity buffer of T = 2048 tokens): every rank's
    ``manual_collective_read``, bit-equal to the whole read, timed."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(241)
    mcfg = get_config("lm100m").replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox", analog_rows=64, analog_cols=64)
    cfg = CrossbarConfig(rows=64, cols=64, adc=AdcConfig(range_mode="dynamic"),
                         device=TAOX_NONOISE)
    rows = []

    def case(path, x, g, ref, ws, xcfg, mc, layout, transpose, label):
        row = shard_read_case(K, S, TM, path, x, g, ref, ws, xcfg, mc,
                              layout, transpose, label)
        rows.append(row)
        report(row)
        print(f"  24(b) {label} ({row['instance']}): whole "
              f"{row['ms']:.3f} ms, {row['shards']} shards "
              f"{'in partials form ' if row['partials_form'] else ''}"
              f"{row['sharded_ms']:.3f} ms in all with the host's hand-overs "
              f"({row['sharded_ms_per_shard']:.3f} a shard), "
              f"{row['sharded_device_ms']} ms of kernels [{gpu_line}]")

    for name, k, n in TRAIN_SHAPES:
        path = ("layers", "ffn" if name.startswith("w_") else "attn", name)
        g = (0.5 + 0.05 * torch.randn((12, k, n), generator=gen,
                                      device=dev)).clamp(0, 1)
        ref = torch.full_like(g, 0.5)
        ws = 1.5 + torch.rand((12,), generator=gen, device=dev)
        for b in SHARD_READ_B:
            for transpose in (False, True):
                x = torch.randn((12, b, n if transpose else k), generator=gen,
                                device=dev)
                for layout in SHARD_LAYOUTS:
                    case(path, x, g, ref, ws, cfg, mcfg, layout, transpose,
                         f"{name} {layout[0]}x{layout[1]} B={b} "
                         f"{'mvm' if transpose else 'vmm'}")
                del x
        del g, ref
    ecfg = get_config(SHARD_EXPERT_ARCH).replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox")
    e, k, n = ecfg.n_experts, ecfg.d_model, ecfg.d_ff_expert or ecfg.d_ff
    cap = -(-int(1.25 * SHARD_T * ecfg.top_k) // e)
    cap = max(8, -(-cap // 8) * 8)
    xcfg = CrossbarConfig(rows=ecfg.analog_rows, cols=ecfg.analog_cols,
                          adc=AdcConfig(range_mode="dynamic"),
                          device=TAOX_NONOISE)
    g = (0.5 + 0.05 * torch.randn((1, e, k, n), generator=gen,
                                  device=dev)).clamp(0, 1)
    ref = torch.full_like(g, 0.5)
    ws = 1.5 + torch.rand((1, e), generator=gen, device=dev)
    for transpose in (False, True):
        x = torch.randn((1, e, cap, n if transpose else k), generator=gen,
                        device=dev)
        case(("layers", "moe", "experts", "w_up"), x, g, ref, ws, xcfg, ecfg,
             SHARD_EXPERT_LAYOUT, transpose,
             f"expert w_up (E {e}) 1x4 B={cap} "
             f"{'mvm' if transpose else 'vmm'}")
        del x
    del g, ref
    print(f"phase 24(b): {len(rows)} sharded reads bit-equal to the whole "
          f"read on every rank")
    return rows


def run_cli(argv, env, what):
    """One training-CLI run under torchrun (one rank); fails on an
    error."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train", *argv]
    t = time.perf_counter()
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"24(c) {what}: the CLI exited {out.returncode}:\n"
             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout, time.perf_counter() - t


def phase_shard_cli(report, gpu_line):
    """24(c): the training CLI under torchrun in a one-rank NCCL group at
    lm100m's full width with QAT (``--analog``: kernel 4 under autograd)
    and int8 gradient compression, 6 steps with a checkpoint at 4; then a
    second run resumed from step 4's checkpoint: steps 5-6 take the same
    batches and the same losses within 1e-6 relative."""
    import gc
    import shutil
    # the CLI runs in its own process: hand it the memory this process's
    # allocator still caches from the earlier phases
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_allocated() / 1e9
    print(f"24(c): {free / 1e9:.1f} of {total / 1e9:.1f} GB free on the card "
          f"for the CLI ({held:.2f} GB still allocated here)")
    if free < SHARD_CLI_FREE_BYTES:
        fail(f"24(c): only {free / 1e9:.1f} GB free for the CLI; "
             f"{held:.2f} GB still allocated by this process")
    work = ROOT / "build" / "shard_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    base = ["--arch", "lm100m", "--mesh", "1x1", "--analog",
            "--grad-compress", "--seq-len", str(SHARD_CLI_SEQ),
            "--global-batch", str(SHARD_CLI_BATCH),
            "--steps", str(SHARD_CLI_STEPS),
            "--ckpt-every", str(SHARD_CLI_RESUME), "--log-every", "1"]
    full_m = work / "full.jsonl"
    log, wall = run_cli(base + ["--ckpt-dir", str(work / "full"),
                                "--metrics-out", str(full_m)], env, "run")
    done = [ln for ln in log.splitlines() if ln.startswith("done:")]
    resume_dir = work / "resume"
    resume_dir.mkdir()
    name = f"step_{SHARD_CLI_RESUME:08d}"
    shutil.copytree(work / "full" / name, resume_dir / name)
    shutil.copy(work / "full" / f"{name}.COMMITTED", resume_dir)
    res_m = work / "resumed.jsonl"
    log2, wall2 = run_cli(base + ["--ckpt-dir", str(resume_dir),
                                  "--metrics-out", str(res_m)], env,
                          "resume")
    if f"resumed from step {SHARD_CLI_RESUME}" not in log2:
        fail(f"24(c): the second run did not resume:\n{log2[-2000:]}")
    full = [json.loads(ln) for ln in open(full_m)]
    again = [json.loads(ln) for ln in open(res_m)]
    if [m["step"] for m in full] != list(range(1, SHARD_CLI_STEPS + 1)) \
            or [m["step"] for m in again] != list(
                range(SHARD_CLI_RESUME + 1, SHARD_CLI_STEPS + 1)):
        fail(f"24(c): steps {[m['step'] for m in full]} / "
             f"{[m['step'] for m in again]}")
    worst = 0.0
    for a, b in zip(full[SHARD_CLI_RESUME:], again):
        if a["batch"] != b["batch"]:
            fail(f"24(c): step {a['step']} resumed on another batch")
        worst = max(worst, abs(a["loss"] - b["loss"]) / abs(a["loss"]))
    if worst > 1e-6:
        fail(f"24(c): resumed losses differ by {worst:.3g} relative")
    reads = [m["fakequant_reads"] for m in full + again]
    if min(reads) <= 0 or len(set(reads)) != 1:
        fail(f"24(c): fakequant reads a step {reads}: every step must read "
             f"through kernel 4, the same count each step")
    tps = float(done[0].split(",")[1].split()[0]) if done else None
    # steady state: the steps after the first (which pays the card's and
    # the kernels' one-time setup)
    secs = [m["seconds"] for m in full]
    steady = SHARD_CLI_SEQ * SHARD_CLI_BATCH / float(np.median(secs[1:]))
    row = {"steps": SHARD_CLI_STEPS, "resume_at": SHARD_CLI_RESUME,
           "step_seconds": secs, "steady_tokens_per_s": steady,
           "losses": [m["loss"] for m in full],
           "resumed_losses": [m["loss"] for m in again],
           "max_rel_loss_diff": worst, "fakequant_reads_per_step": reads[0],
           "tokens_per_s": tps, "run_wall_s": wall, "resume_wall_s": wall2}
    report(row)
    print(f"phase 24(c): the CLI (torchrun, one NCCL rank, lm100m full "
          f"width, QAT + int8 compression) {tps} tokens/s over "
          f"{SHARD_CLI_STEPS} steps, {steady:.1f} after the first (step "
          f"seconds {', '.join(f'{t:.3f}' for t in secs)}; {reads[0]} "
          f"fakequant reads a step); "
          f"resumed at {SHARD_CLI_RESUME}: steps 5-6 same batches, losses "
          f"within {worst:.3g} relative [{gpu_line}]")
    return row


#: Phase 25(a): lm100m's four container shapes at 64x64 tiles and a
#: ragged one; the DAC widths of the paper's variants and the widest the
#: tensor-core instance takes (9 bits: 255 levels); a batch per instance.
BITPLANE_SHAPES = ((768, 2304), (768, 768), (768, 6144), (3072, 768),
                   (200, 72))
BITPLANE_BITS = (2, 4, 8, 9)
BITPLANE_B = {"fp32": 4, "tensor_core": 64}
BITPLANE_LSB = 0.125     # the 16-bit ADC's lsb: the conductance grid's


def bitplane_cfg(CrossbarConfig, AdcConfig, IDEAL, bits):
    """64x64 tiles, an ideal device, a ``bits``-bit DAC and a 16-bit ADC
    at a fixed range whose lsb is :data:`BITPLANE_LSB` exactly."""
    adc = AdcConfig(in_bits=bits, out_bits=16, range_mode="fixed")
    sat = BITPLANE_LSB * adc.out_levels
    adc = AdcConfig(in_bits=bits, out_bits=16, range_mode="fixed",
                    sat_frac=sat / (adc.in_levels * 64 * IDEAL.gmax))
    return CrossbarConfig(rows=64, cols=64, adc=adc, device=IDEAL)


def bitplane_operands(k, n, b, lv, transpose, gen):
    """Drive codes in [-lv, lv] with one pinned at lv (so the DAC scale
    is 1 and the codes come back unchanged), conductances 0.5 + j/8,
    j in [-4, 4], against a reference of 0.5: every charge and partial
    sum is a multiple of 1/8 far below 2^21, exact in float32."""
    drive = n if transpose else k
    x = torch.randint(-lv, lv + 1, (1, b, drive), generator=gen,
                      device="cuda").float()
    x[0, 0, 0] = lv
    g = 0.5 + torch.randint(-4, 5, (1, k, n), generator=gen,
                            device="cuda").float() / 8
    return x, g, torch.full_like(g, 0.5)


def phase_bitplanes(K, REF, CrossbarConfig, AdcConfig, IDEAL, report):
    """25(a): both read kernels on both instances, bit-equal to the
    bit-plane temporal-coding oracle (``kernels.ref.vmm_bitplanes``,
    computed on the card in float32) and so to the integer product."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    ws = torch.ones((1,), device="cuda")
    rows = []
    for bits in BITPLANE_BITS:
        cfg = bitplane_cfg(CrossbarConfig, AdcConfig, IDEAL, bits)
        lv = cfg.adc.in_levels
        for inst, b in BITPLANE_B.items():
            if K.read_instance(b, lv) != inst:
                fail(f"25(a): B={b} at {bits} bits takes the "
                     f"{K.read_instance(b, lv)} instance, not {inst}")
            for k, n in BITPLANE_SHAPES:
                for transpose in (False, True):
                    x, g, ref = bitplane_operands(k, n, b, lv, transpose,
                                                  gen)
                    sc = K.read_scales(x, ws, lv)
                    if not (torch.equal(sc, torch.ones_like(sc))):
                        fail(f"25(a): the DAC scale is not 1: {sc}")
                    y = K._read_cuda(x, g, ref, sc, cfg, transpose)
                    diff = (g - ref)[0]
                    oracle = REF.vmm_bitplanes(
                        x[0], diff.T if transpose else diff, cfg)
                    plain = K._read_plain(x, g, ref, sc, cfg, transpose)
                    torch.cuda.synchronize()
                    row = {"bits": bits, "instance": inst, "B": b, "K": k,
                           "N": n, "transpose": transpose,
                           "bit_equal": torch.equal(y[0], oracle),
                           "plain_bit_equal": torch.equal(plain[0], oracle),
                           "max_abs_err": (y[0] - oracle).abs().max().item()}
                    rows.append(row)
                    report(row)
                    if not (row["bit_equal"] and row["plain_bit_equal"]):
                        fail(f"25(a): a read disagrees with the bit-plane "
                             f"oracle: {row}")
    print(f"phase 25(a): {len(rows)} reads (forward and transpose, FP32 "
          f"and tensor-core instances, {', '.join(map(str, BITPLANE_BITS))}"
          f"-bit DACs, lm100m's containers and a ragged shape) bit-equal "
          f"to the bit-plane oracle")
    return rows


def phase_coverage(KL, report, gpu_line):
    """25(b): ``kernel_lint``'s card half: every kernel and instance on
    ragged shapes and at lm100m's full width, its output a NaN sentinel
    between guard regions; no sentinel left, no guard touched, two
    launches bit-equal."""
    findings, rows = KL.audit_launches()
    for row in rows:
        report(row)
    by_kernel = collections.defaultdict(int)
    for row in rows:
        by_kernel[row["kernel"]] += 1
    if findings:
        fail("25(b): launch coverage: " + "; ".join(map(str, findings)))
    print(f"phase 25(b): {len(rows)} launch-coverage cases clean "
          f"({', '.join(f'{k} {v}' for k, v in by_kernel.items())}): every "
          f"output element written, no guard touched, two launches "
          f"bit-equal [{gpu_line}]")
    return rows


#: 25(c)'s gate on the card's peak over the reckoned one.  The same
#: torch ops run on meta tensors and on the card, with the same autograd
#: structure (the fakequant read saves x and w on both), so autograd
#: saves the same tensors; what differs is the kernels' scratch against
#: the plain versions' transients, and the allocator's rounding.
PEAK_RATIO = (0.9, 1.1)


def _dryrun_case(M, TL, TO, DR, cfg, shape, label, keep=False):
    """One cell of 25(c): the dry run's reckoning of ``cfg``'s train step
    at ``shape`` on one card, and the same step run on the card.  With
    ``keep``, returns the step's new parameters (path -> tensor) beside
    the row."""
    t = time.perf_counter()
    rec = DR.reckon(cfg, shape, DR.make_mesh("1x1"))
    reckon_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    opt = TO.adamw(3e-4)
    state = TL.init_state(0, cfg, opt, device="cuda")
    batch = M.input_specs(cfg, shape, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for k in ("tokens", "labels"):
        batch[k].random_(0, cfg.vocab, generator=gen)
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - base
    storages = {}
    for _, v in M._leaves((state, batch)):
        storages[v.untyped_storage().data_ptr()] = \
            v.untyped_storage().nbytes()
    held = sum(storages.values())
    step = TL.make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    state2, metrics = step(state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - before
    peak = rec["trace"]["peak_bytes"]
    row = {"case": label, "reckoned_argument_bytes": rec["argument_bytes"],
           "allocated_state_bytes": held,
           "memory_allocated_delta": alloc,
           "reckoned_peak_bytes": peak, "card_peak_bytes": card_peak,
           "peak_ratio_card_over_reckoned": card_peak / max(peak, 1),
           "reckoned_flops": rec["trace"]["flops"],
           "reckoned_traffic_bytes": rec["trace"]["traffic_bytes"],
           "reckoned_ops": rec["trace"]["n_ops"], "reckon_s": reckon_s,
           "loss": loss}
    if held != rec["argument_bytes"]:
        fail(f"25(c) {label}: the dry run reckons {rec['argument_bytes']} "
             f"argument bytes; the card holds {held} for the same state "
             "and batch")
    if not math.isfinite(loss):
        fail(f"25(c) {label}: the step's loss is {loss}")
    lo, hi = PEAK_RATIO
    if not lo <= row["peak_ratio_card_over_reckoned"] <= hi:
        fail(f"25(c) {label}: the card's peak {card_peak} bytes is "
             f"{row['peak_ratio_card_over_reckoned']:.3f} of the reckoned "
             f"{peak}, outside {PEAK_RATIO}")
    new = dict(tree_leaves(state2["params"])) if keep else None
    del state, state2
    return (row, new) if keep else row


def phase_dryrun(M, TL, TO, DR, get_config, report, gpu_line):
    """25(c): the dry run's reckoning of two lm100m train steps at 8 x
    256 tokens against the card: the QAT step of phases 17 and 24(c)
    (float32, fakequant) and the digital bfloat16 step (the mode of the
    dry run's table).  Gated: the argument bytes equal the bytes of the
    state and batch allocated for the same step; the card's peak over
    the step within ``PEAK_RATIO`` of the reckoned peak."""
    from repro_torch.configs import ShapeSpec
    shape = ShapeSpec("train_8x256", "train", 256, 8)
    qat = get_config("lm100m").replace(dtype="float32", analog=True,
                                       analog_mode="fakequant")
    rows = [_dryrun_case(M, TL, TO, DR, qat, shape, "qat_fakequant"),
            _dryrun_case(M, TL, TO, DR, get_config("lm100m"), shape,
                         "digital_bf16")]
    for row in rows:
        report(row)
        print(f"phase 25(c): lm100m {row['case']} 8 x 256: argument bytes "
              f"{row['allocated_state_bytes']} reckoned = allocated "
              f"(memory_allocated grew {row['memory_allocated_delta']}); "
              f"peak of the step {row['card_peak_bytes'] / 1e9:.3f} GB on "
              f"the card, {row['reckoned_peak_bytes'] / 1e9:.3f} GB "
              f"reckoned on meta tensors (ratio "
              f"{row['peak_ratio_card_over_reckoned']:.3f}, gated within "
              f"{PEAK_RATIO}); {row['reckoned_flops']:.4e} FLOPs reckoned "
              f"[{gpu_line}]")
    return rows


# --------------------------------------------------------------------------
# Phase 26: per-layer remat (REPRO_REMAT) on the card
# --------------------------------------------------------------------------

#: The policies phase 26 runs; ``none`` is the baseline each is held to.
REMAT_POLICIES = ("none", "full", "dots")
#: The write-noise seed of every phase-26 step (one for all policies).
REMAT_SEED = 12345
#: 26(c): starcoder2-3b at full depth in device mode, one step under the
#: default policy over the first of these (B, S) that fits the card.
REMAT_DEEP_ARCH = "starcoder2-3b"
REMAT_DEEP_SHAPES = ((1, 4096), (1, 2048))


def remat_expect(expect, n_again):
    """A step's launch counts under remat: ``n_again`` forward reads (the
    containers of the rematted blocks) made once more by the backward's
    recompute, each with its own pre-pass and range pass; the transpose
    reads and the writes as in ``expect``."""
    out = dict(expect)
    out["fused_vmm"] += n_again
    for count in READ_KERNEL_COUNTS.values():
        if out[f"{count}_vmm"]:
            out[f"{count}_vmm"] += n_again
    return out


def remat_step(K, U, TA, cfg, state, batch, expect, what):
    """One device-mode step of ``cfg`` from ``state`` (left as it is: the
    step returns a new state) under the policy the caller set: its new
    parameters (path -> tensor), loss, rail fraction, launches (gated
    against ``expect``), step ms and the card's peak."""
    step = TA.make_analog_sgd_step(cfg, lr=0.1)
    reset_launches(K, U)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, mets = step(state, batch, REMAT_SEED)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    got = {**K.LAUNCHES, **U.LAUNCHES}
    if got != expect:
        fail(f"{what} launched {got}; expected {expect}")
    loss = float(mets["loss"])
    if not math.isfinite(loss):
        fail(f"{what}: loss {loss}")
    return {"params": dict(tree_leaves(new["params"])), "loss": loss,
            "g_rail_frac": float(mets["g_rail_frac"]), "launches": got,
            "step_ms": ms,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9}


def remat_agrees(runs, what, rerun, initial):
    """Every policy's new parameters and loss against ``none``'s: bit for
    bit.  A digital leaf (not a conductance) that differs passes only
    where ``rerun()`` (``none`` again) differs from the first ``none`` run
    in that leaf too, i.e. an op of the card that is not deterministic
    run to run, and then within phase 7's CPU-replay class (1e-3 of the
    leaf's move from ``initial()``'s leaves plus 1e-6).  Returns
    {policy: differing leaves} and the leaves found nondeterministic."""
    base = runs["none"]
    again, init, nondet, diff = None, None, [], {}
    for pol, run in runs.items():
        if pol == "none":
            continue
        if run["loss"] != base["loss"] \
                or run["g_rail_frac"] != base["g_rail_frac"]:
            fail(f"{what}: {pol}'s loss / rail fraction {run['loss']} / "
                 f"{run['g_rail_frac']} differ from none's {base['loss']} "
                 f"/ {base['g_rail_frac']}")
        off = [p for p, v in run["params"].items()
               if not torch.equal(v, base["params"][p])]
        diff[pol] = ["/".join(p) for p in off]
        for p in off:
            if p[-1] in ("g", "g_carry", "ref", "w_scale"):
                fail(f"{what}: {'/'.join(p)} under {pol} differs from "
                     "none's")
            if again is None:
                again, init = rerun(), initial()
            if torch.equal(again["params"][p], base["params"][p]):
                fail(f"{what}: {'/'.join(p)} under {pol} differs from "
                     "none's, and none reproduces itself on the card")
            if p not in nondet:
                nondet.append(p)
            v, w = run["params"][p].float(), base["params"][p].float()
            bound = 1e-3 * (w - init[p].float()).abs().max() + 1e-6
            if ((v - w).abs() > bound).any():
                fail(f"{what}: {'/'.join(p)} under {pol} differs from "
                     f"none's by {(v - w).abs().max().item()}, over the "
                     f"CPU-replay class ({bound.item()})")
    return diff, ["/".join(p) for p in nondet]


def rerun_none(K, U, TA, cfg, state, batch, expect, what):
    """:func:`remat_agrees`' ``rerun`` and ``initial`` for a device-mode
    step from ``state``: ``none``'s step once more, the state's leaves."""
    def run():
        with env_set("REPRO_REMAT", "none"):
            return remat_step(K, U, TA, cfg, state, batch, expect,
                              f"{what} (none again)")
    return run, lambda: dict(tree_leaves(state["params"]))


def card_batch(syn, cfg, b, s):
    stream = syn.make_token_stream(200_000, cfg.vocab, seed=0)
    x, y = syn.batch_tokens(stream, b, s, 0)
    return {"tokens": torch.from_numpy(x).long().cuda(),
            "labels": torch.from_numpy(y).long().cuda()}


def phase_remat_train(K, U, TA, syn, tcfg, report, gpu_line):
    """26(a): lm100m in device mode with phase 7's settings (full width,
    TaOx, 64x64 tiles, lr 0.1, 8 x 256 tokens, init seed 0), one step
    under each policy from one state, with one ``seed_base``.  Gates: the
    three new states and losses bit-equal (:func:`remat_agrees`); 48
    forward reads, 48 transpose reads and 4 writes under ``none``, 48
    more forward reads (the recompute) under ``full`` and ``dots``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = TA.init_state(gen, tcfg, device="cuda")
    batch = card_batch(syn, tcfg, 8, 256)
    n = 4 * tcfg.n_layers
    base = tensor_core_train_expect(
        tcfg.n_layers, fakequant=0, **dict.fromkeys(FQ_KERNELS.values(), 0),
        outer_update=4, pulse_update=0, update_tc=4, update_prepare=4,
        update_fp32=0)
    runs = {}
    for pol in REMAT_POLICIES:
        with env_set("REPRO_REMAT", pol):
            runs[pol] = remat_step(
                K, U, TA, tcfg, state, batch,
                base if pol == "none" else remat_expect(base, n),
                f"26(a) lm100m under {pol}")
    diff, nondet = remat_agrees(runs, "26(a) lm100m", *rerun_none(
        K, U, TA, tcfg, state, batch, base, "26(a) lm100m"))
    res = {"config": "lm100m, device mode, TaOx, 64x64 tiles, 8 x 256",
           "nondeterministic_leaves": nondet, "differing_leaves": diff,
           **{pol: {k: v for k, v in r.items() if k != "params"}
              for pol, r in runs.items()}}
    report(res)
    for pol, r in runs.items():
        print(f"phase 26(a): lm100m one device-mode step under "
              f"REPRO_REMAT={pol}: loss {r['loss']:.6f}, forward reads "
              f"{r['launches']['fused_vmm']}, transpose reads "
              f"{r['launches']['fused_mvm']}, writes "
              f"{r['launches']['update_tc']}, {r['step_ms']:.1f} ms, "
              f"max_memory_allocated {r['max_memory_allocated_gb']:.3f} GB "
              f"[{gpu_line}]")
    print(f"phase 26(a): full and dots bit-equal to none in every "
          f"conductance, digital leaf and the loss"
          + (f" but the card's nondeterministic {nondet}" if nondet else ""))
    del runs, state
    return res


def phase_remat_dryrun(M, K, TL, TO, DR, get_config, report, gpu_line):
    """26(b): 25(c)'s two lm100m cells (the QAT step and the digital
    bfloat16 step, 8 x 256 tokens, adamw) under each policy: 25(c)'s
    gates under the same policy (argument bytes equal, the card's peak
    within ``PEAK_RATIO`` of the dry run's reckoning), the new
    parameters bit-equal to ``none``'s (:func:`remat_agrees`), and the
    QAT step's fakequant reads (kernel 4 on its tensor-core instance) 48
    a step under ``none``, 96 (48 recomputed) under ``full`` and
    ``dots``."""
    from repro_torch.configs import ShapeSpec
    shape = ShapeSpec("train_8x256", "train", 256, 8)
    cells = {"qat_fakequant": get_config("lm100m").replace(
        dtype="float32", analog=True, analog_mode="fakequant"),
        "digital_bf16": get_config("lm100m")}
    per = 4 * get_config("lm100m").n_layers
    rows, runs = [], {label: {} for label in cells}
    for pol in REMAT_POLICIES:
        for label, cfg in cells.items():
            for name in K.LAUNCHES:
                K.LAUNCHES[name] = 0
            with env_set("REPRO_REMAT", pol):
                row, new = _dryrun_case(M, TL, TO, DR, cfg, shape,
                                        f"{label}_{pol}", keep=True)
            got = {name: K.LAUNCHES[c] for name, c in FQ_KERNELS.items()}
            reads = 0 if label == "digital_bf16" \
                else per * (1 if pol == "none" else 2)
            want = {"fakequant_scale_kernel": 0, "fakequant_fp32_kernel": 0,
                    "fakequant_prepare_kernel": reads,
                    "fakequant_tc_kernel": reads,
                    "fakequant_epilogue_kernel": reads}
            if got != want or K.LAUNCHES["fakequant"] != reads:
                fail(f"26(b) {label} under {pol} launched {got}; expected "
                     f"{want}")
            row.update(remat=pol, fakequant_launches=got)
            rows.append(row)
            runs[label][pol] = {"params": new, "loss": row["loss"],
                                "g_rail_frac": 0.0}
            print(f"phase 26(b): lm100m {label} 8 x 256 under "
                  f"REPRO_REMAT={pol}: peak {row['card_peak_bytes'] / 1e9:.3f}"
                  f" GB on the card, {row['reckoned_peak_bytes'] / 1e9:.3f} "
                  f"GB reckoned (ratio "
                  f"{row['peak_ratio_card_over_reckoned']:.3f}, gated within "
                  f"{PEAK_RATIO}); {row['reckoned_flops']:.4e} FLOPs "
                  f"reckoned; fakequant reads {reads} [{gpu_line}]")
    for label, by_pol in runs.items():
        def rerun(label=label):
            with env_set("REPRO_REMAT", "none"):
                row, new = _dryrun_case(M, TL, TO, DR, cells[label], shape,
                                        f"{label}_none_again", keep=True)
            return {"params": new, "loss": row["loss"]}

        def initial(label=label):     # _dryrun_case's initial state
            return dict(tree_leaves(TL.init_state(
                0, cells[label], TO.adamw(3e-4), device="cuda")["params"]))
        diff, nondet = remat_agrees(by_pol, f"26(b) {label}", rerun,
                                    initial)
        rows.append({"case": label, "differing_leaves": diff,
                     "nondeterministic_leaves": nondet})
        print(f"phase 26(b): lm100m {label}: the parameters after one step "
              f"under full and dots bit-equal to none's"
              + (f" but the card's nondeterministic {nondet}"
                 if nondet else ""))
    for row in rows:
        report(row)
    del runs
    return rows


def edge_recorders(K, U, state, n_layers, reads, writes):
    """Stand-ins for ``K._read_cuda`` and ``U._update_cuda`` that record
    only the first and last layers' launches: a read whose conductances
    are layer 0 or ``n_layers - 1`` of a container, with its operands and
    result; each write's two layers, sliced, at their own layer offsets.
    Returns (recording read, recording write, real read, real write)."""
    from repro_torch.core.analog_registry import container_paths
    edge = {}
    for path in container_paths(state["params"]):
        g = tree_get(state["params"], path)["g"]
        for i in (0, n_layers - 1):
            edge[g[i].data_ptr()] = ("/".join(path), i)
    read_cuda, update_cuda = K._read_cuda, U._update_cuda

    def read(x, g, ref, sc, cfg, transpose=False, *a, **kw):
        y = read_cuda(x, g, ref, sc, cfg, transpose, *a, **kw)
        where = edge.get(g.data_ptr())
        if where is not None:
            reads.append((where, (x.clone(), g, ref, sc.clone(), cfg,
                                  y.clone(), transpose)))
        return y

    def write(*args, **kw):
        out = update_cuda(*args, **kw)
        g, x_q, d_q, scale, noise, seed, cfg, mode, xs, ds, offs = \
            write_call(update_cuda, args, kw)
        for i in (0, g.shape[0] - 1):
            sl = slice(i, i + 1)
            writes.append(((g[sl], x_q[sl].clone(), d_q[sl].clone(),
                            scale[sl].clone(),
                            None if noise is None else noise[sl], seed, cfg,
                            mode, None if xs is None else xs[sl].clone(),
                            None if ds is None else ds[sl].clone(),
                            (offs[0] + i, offs[1], offs[2])),
                           out[sl].clone()))
        return out
    return read, write, read_cuda, update_cuda


def reckon_device_step(TA, cfg, shape, policy):
    """The dry run's reckoning of ``cfg``'s device-mode step over
    ``shape`` (B, S) tokens on meta tensors under ``policy``: the
    arguments (state and batch), the peak of the step's temporaries (the
    plain versions' in place of the kernels'), its FLOPs."""
    from repro_torch.launch.trace_analysis import tracing
    with env_set("REPRO_REMAT", policy):
        state = TA.init_state(0, cfg, device="meta")
        batch = {k: torch.zeros(shape, dtype=torch.long, device="meta")
                 for k in ("tokens", "labels")}
        t = time.perf_counter()
        with tracing(dry=True) as trace:
            TA.make_analog_sgd_step(cfg, lr=0.1)(state, batch, REMAT_SEED)
    args = sum(v.numel() * v.element_size()
               for tree in (state, batch) for _, v in tree_leaves(tree))
    return {"argument_gb": args / 1e9, "temp_gb": trace.peak_bytes / 1e9,
            "total_gb": (args + trace.peak_bytes) / 1e9,
            "flops": trace.flops, "reckon_s": time.perf_counter() - t}


def phase_remat_deep(K, U, TA, syn, get_config, report, gpu_line):
    """26(c): starcoder2-3b at full size in device mode (phase 16's
    settings at 30 of 30 layers: TaOx, 64x64 tiles, lr 0.1), one step over
    1 x 4096 tokens under ``full`` (1 x 2048 if that does not fit).
    Gates: a finite loss; the conductances in the window; 240 forward
    reads (120 of them the recompute), 120 transpose reads and 4 writes,
    all on the tensor-core instances; the first and last layers' reads
    and writes against their plain versions (phase 7's classes), each
    recomputed forward read bit-equal to its original.  Beside the card's
    step ms and peak, the dry-run reckoning under ``none`` and ``full``."""
    cfg = get_config(REMAT_DEEP_ARCH).replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox", analog_rows=64, analog_cols=64)
    L = cfg.n_layers
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9   # earlier phases'
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    state = TA.init_state(gen, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    expect = remat_expect(tensor_core_train_expect(
        L, fakequant=0, **dict.fromkeys(FQ_KERNELS.values(), 0),
        outer_update=4, pulse_update=0, update_tc=4, update_prepare=4,
        update_fp32=0), 4 * L)
    step = TA.make_analog_sgd_step(cfg, lr=0.1)
    reads, writes, notes = [], [], []
    for shape in REMAT_DEEP_SHAPES:
        batch = card_batch(syn, cfg, *shape)
        read, write, read_cuda, update_cuda = edge_recorders(
            K, U, state, L, reads, writes)
        K._read_cuda, U._update_cuda = read, write
        reset_launches(K, U)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with env_set("REPRO_REMAT", "full"):
                new, mets = step(state, batch, REMAT_SEED)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            notes.append(f"{shape[0]} x {shape[1]} did not fit: "
                         f"{str(e).splitlines()[0]}")
            print(f"phase 26(c): {notes[-1]}")
            reads.clear()
            writes.clear()
            del batch
            torch.cuda.empty_cache()
            continue
        finally:
            K._read_cuda, U._update_cuda = read_cuda, update_cuda
        break
    else:
        fail(f"26(c): {REMAT_DEEP_ARCH}'s step fits none of "
             f"{REMAT_DEEP_SHAPES}: {notes}")
    step_ms = 1e3 * (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = {**K.LAUNCHES, **U.LAUNCHES}
    if got != expect:
        fail(f"26(c) {REMAT_DEEP_ARCH} step launched {got}; expected "
             f"{expect}")
    loss = float(mets["loss"])
    if not math.isfinite(loss):
        fail(f"26(c) {REMAT_DEEP_ARCH}: loss {loss}")
    for path, g in tree_leaves(new["params"]):
        if path[-1] == "g" and not (g.min() >= 0 and g.max() <= 1):
            fail(f"26(c): conductances of {path} left the window")
    del new, state
    # each recomputed forward read against its original, the originals
    # and the transpose reads against the plain version
    first, recomputed = {}, 0
    checked = []
    for where, r in reads:
        key = (where, r[6])
        if r[6] or key not in first:
            first[key] = r
            checked.append(r)
            continue
        o = first[key]
        if not (torch.equal(o[0], r[0]) and torch.equal(o[5], r[5])):
            fail(f"26(c): the recomputed forward read of {where} differs "
                 "from its original")
        recomputed += 1
    if recomputed != 4 * 2 or len(checked) != 4 * 2 * 2:
        fail(f"26(c): {recomputed} recomputed and {len(checked)} other "
             "reads of the first and last layers recorded; expected 8 and "
             "16")
    worst_r = check_reads(K, checked, where="cuda")
    worst_w = check_writes(U, writes, f"26(c) {REMAT_DEEP_ARCH} step")
    del reads, writes, checked, first
    torch.cuda.empty_cache()
    reckoned = {pol: reckon_device_step(TA, cfg, shape, pol)
                for pol in ("none", "full")}
    res = {"config": REMAT_DEEP_ARCH,
           "cut": f"{L} of {L} layers, full widths; one step over "
                  f"{shape[0]} x {shape[1]} tokens",
           "shape": list(shape), "notes": notes, "init_s": init_s,
           "resident_before_gb": resident_gb,
           "loss": loss, "step_ms": step_ms, "launches": got,
           "card_peak_gb": peak_gb, "reads_checked": 16,
           "recomputed_reads_bit_equal": recomputed,
           **{f"reads_{k}": v for k, v in worst_r.items()},
           "writes_checked": 8,
           **{f"writes_{k}": v for k, v in worst_w.items()},
           "reckoned": reckoned}
    report(res)
    print(f"phase 26(c): {REMAT_DEEP_ARCH} ({res['cut']}) one device-mode "
          f"step under REPRO_REMAT=full: loss {loss:.5f}, {step_ms:.1f} ms, "
          f"card peak {peak_gb:.2f} GB ({resident_gb:.2f} GB held before "
          f"the phase); launches {got['fused_vmm']} forward "
          f"({4 * L} recomputed), {got['fused_mvm']} transpose, "
          f"{got['update_tc']} writes; the first and last layers' 16 reads "
          f"({worst_r['max_err_over_bound']:.3f} of the bound) and 8 "
          f"written layers ({worst_w['max_err_over_twin_bound']:.3f} of the "
          f"twin's bound) agree with their plain versions, 8 recomputed "
          f"reads bit-equal to their originals [{gpu_line}]")
    for pol, r in reckoned.items():
        print(f"phase 26(c): reckoned (dry run, meta tensors) under "
              f"REPRO_REMAT={pol}: {r['argument_gb']:.1f} + "
              f"{r['temp_gb']:.1f} = {r['total_gb']:.1f} GB "
              f"(args + temps), {r['flops']:.4e} FLOPs")
    if notes:
        print(f"phase 26(c): took {shape[0]} x {shape[1]} tokens: "
              + "; ".join(notes))
    return res


def phase_remat_hybrid(K, U, TA, syn, get_config, report, gpu_line):
    """26(d): zamba2-1.2b in device mode at 21(b)'s cut (13 layers, two
    shared-block applications between rematted SSD groups; TaOx, 64x64
    tiles, lr 0.1, 8 x 256 tokens), one step under ``none`` and ``full``
    from one state.  Gates: bit-equal new states and losses; 21(b)'s
    launches under ``none``, the 26 SSD layers' forward reads once more
    under ``full`` (the shared block is not rematted)."""
    from repro_torch.core.analog_registry import container_paths, tape_reps
    torch.cuda.empty_cache()
    n_layers = HYBRID_TRAIN_LAYERS
    cfg = get_config(HYBRID_ARCH).replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox", analog_rows=64, analog_cols=64,
        n_layers=n_layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = TA.init_state(gen, cfg, device="cuda")
    batch = card_batch(syn, cfg, 8, 256)
    n_reads = ssm_reads(state["params"], cfg)
    n_shared = sum(tape_reps(p, cfg) > 1
                   for p in container_paths(state["params"]))
    base = tensor_core_train_expect(
        n_layers, fakequant=0, **dict.fromkeys(FQ_KERNELS.values(), 0),
        outer_update=2 + n_shared, pulse_update=0, update_tc=2,
        update_prepare=2, update_fp32=n_shared)
    for d in ("vmm", "mvm"):
        for c in READ_KERNEL_COUNTS.values():
            if base[f"{c}_{d}"]:
                base[f"{c}_{d}"] = n_reads
        base[f"fused_{d}"] = n_reads
    runs = {}
    for pol in ("none", "full"):
        with env_set("REPRO_REMAT", pol):
            runs[pol] = remat_step(
                K, U, TA, cfg, state, batch,
                base if pol == "none" else remat_expect(base, 2 * n_layers),
                f"26(d) {HYBRID_ARCH} under {pol}")
    diff, nondet = remat_agrees(runs, f"26(d) {HYBRID_ARCH}", *rerun_none(
        K, U, TA, cfg, state, batch, base, f"26(d) {HYBRID_ARCH}"))
    res = {"config": HYBRID_ARCH,
           "cut": f"{n_layers} layers, full widths; 8 x 256 tokens",
           "nondeterministic_leaves": nondet, "differing_leaves": diff,
           **{pol: {k: v for k, v in r.items() if k != "params"}
              for pol, r in runs.items()}}
    report(res)
    print(f"phase 26(d): {HYBRID_ARCH} ({res['cut']}) one device-mode step "
          f"under none and full: bit-equal"
          + (f" but the card's nondeterministic {nondet}" if nondet else "")
          + "; forward reads " + ", ".join(
              f"{p} {r['launches']['fused_vmm']}" for p, r in runs.items())
          + f", transpose {runs['none']['launches']['fused_mvm']}, writes "
          f"{n_shared} FP32 + 2 tensor-core; "
          + ", ".join(f"{p} {r['step_ms']:.1f} ms" for p, r in runs.items())
          + f" [{gpu_line}]")
    del runs, state
    return res


def phase_prefill_head(M, get_config, report, gpu_line):
    """26(e): the prefill head on the card.  ``models.model.prefill``
    applies the final norm and the head to the last position alone (a
    1-row product a sequence); the same logits are the last row of the
    full forward's (B x S rows).  lm100m (tied head: a float32 product)
    and starcoder2-3b at 2 layers (its own head, in the activation dtype),
    digital, float32 and bfloat16, 4 x 64 tokens from seed 0.  Gate: the
    float32 cases within the forward's class (1e-5 relative and absolute,
    ``tests/test_torch_prefill_head.py``); the bfloat16 ones are stated."""
    rows = []
    for arch, layers in (("lm100m", None), ("starcoder2-3b", 2)):
        for dtype in ("float32", "bfloat16"):
            cfg = get_config(arch).replace(dtype=dtype)
            if layers:
                cfg = cfg.replace(n_layers=layers)
            params = M.init_params(cfg, 0, device="cuda")
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            tokens = torch.randint(0, cfg.vocab, (4, 64), device="cuda",
                                   generator=gen)
            with torch.no_grad():
                head, _ = M.prefill(params, {"tokens": tokens}, cfg, 64)
                full, _ = M.forward(params, {"tokens": tokens}, cfg)
            full = full[:, -1]
            err = (head - full).abs().max().item()
            scale = full.abs().max().item()
            row = {"arch": arch, "layers": layers or cfg.n_layers,
                   "dtype": dtype, "max_abs_err": err,
                   "max_abs_logit": scale,
                   "bit_equal": bool(torch.equal(head, full))}
            rows.append(row)
            report(row)
            print(f"phase 26(e): {arch} {dtype} prefill head (one row a "
                  f"sequence) vs the full forward's last row: max abs err "
                  f"{err:.3g} of logits up to {scale:.3g}"
                  + (", bit-equal" if row["bit_equal"] else "")
                  + f" [{gpu_line}]")
            if dtype == "float32" and not torch.allclose(
                    head, full, rtol=1e-5, atol=1e-5):
                fail(f"26(e): {arch}'s float32 prefill head differs from "
                     f"the full forward's last row by {err}")
            del params
    return rows


# --------------------------------------------------------------------------
# Phase 27: FSDP and tensor parallelism of the numeric step, exact=False
# --------------------------------------------------------------------------

#: 27(a): the layouts of lm100m's QAT step, its global batch, seed and lr.
TP_LAYOUTS = ((2, 2), (1, 4), (4, 1))
TP_BATCH = (8, 256)
TP_SEED = 27
TP_LR = 1e-3
#: 27(b): gemma-2b's global batch on 4x1: one 1024-token sequence a rank
#: (4096 tokens; 4 x 2048 would hold the 1x1 step's float32 logits and
#: their gradient at 8192 x 256000, too close to 80 GB beside its state).
GEMMA_BATCH = (4, 1024)
#: 27(b)'s depth: 6 of gemma-2b's 18 layers (cut for the script's time
#: limit once phase 29 joined)
GEMMA_TP_LAYERS = 3
#: 27(c): the exact=False layout and its batches.
INEXACT_LAYOUT = (2, 4)
INEXACT_B = (4, 2048)
INEXACT_SEED_BASE = 2727
#: 27(c)'s yardsticks: the one-device step with the embedding nudged one
#: ulp up, every element (None) or a random half of them (these seeds).
NUDGE_SEEDS = (None, 1, 2, 3)
#: 27(c)'s planted fault: this rank's own tile sum dropped in the
#: exact=False step's first read (layer 0's wqkv).
FAULT_RANK = 1
#: 27(c)'s limit on the exact=False step's write distance from the exact
#: step's, in units of the largest nudge's: the exact=False step read
#: 0.97-0.99 of it, the planted fault 1.22-1.81 (PERF.md section 6).
WRITE_LIMIT = 1.15


#: 27(a)'s depth: lm100m cut to 6 of its 12 layers (for the time limit)
TP_QAT_LAYERS = 6


def tp_qat_cfg(get_config):
    """lm100m's QAT cell at 128-row tiles (phase 17's 1024-row tiles
    leave ``wo`` and ``w_down`` whole on every layout): ``w_down`` then
    splits at whole tiles on 2x2 and 1x4 and ``wo`` on 2x2, so the step
    runs kernel 4's row-split (tiles) form beside its column split."""
    return get_config("lm100m").replace(dtype="float32", analog=True,
                                        analog_mode="fakequant",
                                        analog_rows=128,
                                        n_layers=TP_QAT_LAYERS)


def gemma_tp_cfg(get_config):
    """27(b)'s gemma-2b: full width, GEMMA_TP_LAYERS of its 18 layers."""
    return get_config("gemma-2b").replace(n_layers=GEMMA_TP_LAYERS)


def tp_inexact_cfg(get_config):
    """Phase 7's settings."""
    return get_config("lm100m").replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox", analog_rows=64, analog_cols=64)


def tp_tokens(vocab, b, s, rows=None):
    """The phase's global batch (numpy seed 27), or its ``rows``."""
    rng = np.random.default_rng(TP_SEED)
    x = rng.integers(0, vocab, (b, s + 1))
    x = x if rows is None else x[rows]
    return {"tokens": torch.from_numpy(x[:, :-1]).long().cuda(),
            "labels": torch.from_numpy(x[:, 1:]).long().cuda()}


def local_rows(mesh, b):
    d, n = mesh.coords["data"], mesh.shape["data"]
    return slice(d * b // n, (d + 1) * b // n)


def tree_nbytes(tree):
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def leaves_of(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_of(tree[k], path + (k,))
    else:
        yield path, tree


def timed_step(step, state, batch, *args):
    """One step between CUDA events: ``(state, metrics, ms)``."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    state, m = step(state, batch, *args)
    ev[1].record()
    torch.cuda.synchronize()
    return state, m, ev[0].elapsed_time(ev[1])


def collective_bytes(before=None):
    """The bytes this rank received through the numeric step's collectives
    (``core.shardctx.GATHERED["numeric"]``, by mesh axis, as a ring moves
    them) since ``before``, or (``before`` None) a copy of the counts to
    take the difference from."""
    from repro_torch.core import shardctx
    now = dict(shardctx.GATHERED["numeric"])
    if before is None:
        return now
    return {a: now[a] - before.get(a, 0) for a in now}


def split_read_case(K, mesh, cfg, adc, k=None, n=None, parts=None, t=None):
    """One column-split fakequant read at 27(a)'s shapes (2048 tokens,
    lm100m's ``wqkv`` split over ``model``; ``k`` x ``n`` another leaf's,
    28(a)'s MLA ``wq``; ``parts`` a fused leaf's parts, each rank's
    columns of them as ``launch.sharding.part_columns`` gives them and the
    gathered range partials put in the whole width's order by
    ``range_blocks``, a part whole on every rank taken from the first;
    ``t`` tokens): the kernels' split form (range
    partials gathered over ``model``) bit-equal to the whole read's
    columns, and against the plain split version on the same inputs,
    whose partials are gathered in turn, in ``fq_agrees``' bound with the
    lsb of the whole width.  Times the kernels' split form and its plain version on
    this rank's columns (one rank's combine left out)."""
    from repro_torch.kernels.xbar_vmm import (_fakequant_plain_finish,
                                              _fakequant_plain_head)
    from repro_torch.launch.sharding import part_columns, range_blocks
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    t, k = t or TP_BATCH[0] * TP_BATCH[1], k or cfg.d_model
    n = n or (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.resolved_head_dim
    rows = cfg.analog_rows
    x = torch.randn((t, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    m, r = mesh.shape["model"], mesh.coords["model"]
    parts = parts or [(n, True)]
    cols = part_columns(parts, m, r).cuda()
    blocks = range_blocks(parts, m)
    c = len(cols)
    wr = w.index_select(1, cols).contiguous()

    def combine(s):     # rank order, then the whole width's block order
        s = mesh.all_gather(s, "model", s.ndim - 1)
        return s if blocks is None else s.index_select(-1, blocks.cuda())
    y_k, _ = K.fakequant_split_read(x, wr, adc, rows, combine, n)
    whole = K.fakequant_read(x, w, adc, rows).index_select(1, cols)
    sc = K.fakequant_scale(x, adc.in_levels)
    q_p, ssq_p = _fakequant_plain_head(x, wr, sc, adc, rows)
    tot = combine(ssq_p).sum(dim=-1)
    y_p = _fakequant_plain_finish(q_p, combine(ssq_p), n, adc)
    lsb = adc.sat_sigmas * torch.sqrt(tot / n + 1e-12) / adc.out_levels
    err = (y_k - y_p).abs()
    bound = lsb.sum(1, keepdim=True) + 1e-5 * torch.maximum(y_p.abs(),
                                                            y_k.abs())
    share = (err > 1e-5 * y_p.abs().amax()).float().mean().item()
    sync = torch.cuda.synchronize

    def kernel(i=0):
        head, s = K._fakequant_split_cuda(x, wr, adc, rows)
        return K._fakequant_finish_cuda(head, s, n, adc)

    def plain(i=0):
        q, s = _fakequant_plain_head(x, wr, sc, adc, rows)
        return _fakequant_plain_finish(q, s, n, adc)
    before = K.LAUNCHES["fakequant_split"]
    ms = cuda_ms(kernel, 5, sync)
    plain_ms = cuda_ms(plain, 5, sync)
    K.LAUNCHES["fakequant_split"] = before   # timing launches not counted
    return {"ok": bool((err <= bound).all()) and share < 0.01,
            "bit_equal_whole_read": bool(torch.equal(y_k, whole)),
            "max_abs_err": err.max().item(),
            "worst_err_over_bound": (err / bound).max().item(),
            "flip_share": share, "T": t, "K": k, "N_rank": c, "N": n,
            "ms": ms, "plain_ms": plain_ms, **fq_bounds(t, k, c)}


def tiles_read_case(K, mesh, cfg, adc, k=None, n=None, t=None):
    """One row-split fakequant read at 27(a)'s shapes (2048 tokens,
    lm100m's ``w_down`` split over ``model`` at whole row tiles; ``k``
    rows another leaf's, 28(a)'s MLA ``wo``; ``n`` its columns where they
    are not ``d_model``; ``t`` tokens): the
    kernels' tiles form (this rank's tiles' products and range partials
    gathered in tile order, the epilogue over every tile) bit-equal to
    the whole read, and against the plain version of the same steps in
    ``fq_agrees``' class.  Times the kernels' form and its plain version
    on this rank (the gather left out)."""
    from repro_torch.kernels.xbar_vmm import (_fakequant_plain_finish,
                                              _fakequant_plain_head)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    t, k, n = t or TP_BATCH[0] * TP_BATCH[1], k or cfg.d_ff, n or cfg.d_model
    rows = cfg.analog_rows
    x = torch.randn((t, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    m, r = mesh.shape["model"], mesh.coords["model"]
    kr = k // m
    xr = x[:, r * kr:(r + 1) * kr].contiguous()
    wr = w[r * kr:(r + 1) * kr].contiguous()

    def combine(q):     # contiguous row tiles: rank order is tile order
        return mesh.all_gather(q, "model", 1)
    sc = mesh.all_reduce(K.fakequant_scale(xr, adc.in_levels), "model",
                         op="max")
    y_k = K.fakequant_tiles_read(xr, wr, adc, rows, combine, sc)
    whole = K.fakequant_read(x, w, adc, rows)
    q_p, ssq_p = _fakequant_plain_head(xr, wr, sc, adc, rows)
    q_all, ssq_all = combine(q_p), combine(ssq_p)
    y_p = _fakequant_plain_finish(q_all, ssq_all, n, adc)
    ok, err, ratio, share = fq_agrees(y_k, y_p, x, w, sc, adc, rows)
    sync = torch.cuda.synchronize
    _, s_k, q_k = K._fakequant_split_cuda(xr, wr, adc, rows, sc, q_out=True)
    q_k, s_k = combine(q_k), combine(s_k)
    before = (K.LAUNCHES["fakequant_split"], K.LAUNCHES["fakequant_tiles"])

    def kernel(i=0):
        K._fakequant_split_cuda(xr, wr, adc, rows, sc, q_out=True)
        return K._fakequant_tiles_cuda(q_k, s_k, adc)

    def plain(i=0):
        q, _ = _fakequant_plain_head(xr, wr, sc, adc, rows)
        return _fakequant_plain_finish(q_all, ssq_all, n, adc)
    ms = cuda_ms(kernel, 5, sync)
    plain_ms = cuda_ms(plain, 5, sync)
    # timing launches not counted
    K.LAUNCHES["fakequant_split"], K.LAUNCHES["fakequant_tiles"] = before
    bound = fq_bounds(t, kr, n)
    # beyond the read's own x, W and y: every tile's q read by the epilogue
    extra = 4 * t * (k // rows) * n
    t_bytes = 1e-3 * bound["bytes_ms"] + extra / HBM_BYTES_PER_S
    t_ops = 2 * t * kr * n / FP32_FLOPS
    return {"ok": ok, "bit_equal_whole_read": bool(torch.equal(y_k, whole)),
            "max_abs_err": err, "worst_err_over_bound": ratio,
            "flip_share": share, "T": t, "K_rank": kr, "K": k, "N": n,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "tc_floor_ms": max(bound["tc_floor_ms"], 1e3 * t_bytes)}


def split_kernel_cases(K, adc, rows, report):
    """Kernel 4's new entries on one rank against their plain versions,
    on both instances (16 and 2048 tokens, lm100m's wqkv width): the
    split form with its own partials (one rank: bit-equal to the whole
    read) and a read at a given DAC scale (a row split's), each in
    fq_agrees' class."""
    from repro_torch.kernels.xbar_vmm import _fakequant_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    k, n = 768, 2304
    out = []
    for t in (16, 2048):
        x = torch.randn((t, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        sc = K.fakequant_scale(x, adc.in_levels)
        y_p = _fakequant_plain(x, w, sc, adc, rows)
        y_s, _ = K.fakequant_split_read(x, w, adc, rows, lambda s: s, n)
        if not torch.equal(y_s, K.fakequant_read(x, w, adc, rows)):
            fail(f"27(a) kernel 4's split form at T={t} on one rank is not "
                 "the whole read bit for bit")
        given = sc * 1.5
        y_g = K.fakequant_read(x, w, adc, rows, sc=given)
        y_gp = _fakequant_plain(x, w, given, adc, rows)
        for what, y_k, ref, scale in (("split", y_s, y_p, sc),
                                      ("given_scale", y_g, y_gp, given)):
            ok, err, ratio, share = fq_agrees(y_k, ref, x, w, scale, adc,
                                              rows)
            row = {"case": what, "T": t, "instance":
                   K.fakequant_instance(t, adc.in_levels), "ok": ok,
                   "max_abs_err": err, "worst_err_over_bound": ratio,
                   "flip_share": share}
            if not ok:
                fail(f"27(a) kernel 4's {what} entry at T={t}: {row}")
            report(row)
            out.append(row)
    return out


def tp_rank_qat(rank, src):
    """27(a) on one rank: for each layout, lm100m's QAT step from the
    whole initial state cut into blocks, timed; the whole parameters
    after it (rank 0), the step's launches and one split read held
    against its plain version."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    cfg = tp_qat_cfg(get_config)
    adc = AdcConfig(in_bits=cfg.analog_in_bits, out_bits=cfg.analog_out_bits)
    out = {}
    for shape in TP_LAYOUTS:
        mesh = card_mesh(shape)
        opt = adamw(TP_LR)
        state = TL.init_sharded_state(TP_SEED, cfg, opt, mesh, "cuda")
        step = TL.make_train_step(cfg, opt, mesh=mesh)
        batch = tp_tokens(cfg.vocab, *TP_BATCH,
                          rows=local_rows(mesh, TP_BATCH[0]))
        step(state, batch)      # warm-up (the step leaves its input state)
        for name in K.LAUNCHES:
            K.LAUNCHES[name] = 0
        state, mets, ms = timed_step(step, state, batch)
        launches = dict(K.LAUNCHES)
        loss = mesh.all_reduce(mets["loss"].reshape(1), "data") \
            / mesh.shape["data"]
        whole = TL.unshard_state(state, cfg, mesh)["params"]
        out[shape] = {
            "loss": float(loss), "grad_norm": float(mets["grad_norm"]),
            "ms": ms, "launches": launches,
            "plan": {k: getattr(step.numeric, k) for k in (
                "attn", "attn_row", "ffn", "ffn_row", "vocab")},
            "params": params_to_numpy(whole) if rank == 0 else None,
            **({"split": split_read_case(K, mesh, cfg, adc),
                "tiles": tiles_read_case(K, mesh, cfg, adc)}
               if mesh.shape["model"] > 1 else {})}
        del state, whole
        torch.cuda.empty_cache()
    return out


def tp_rank_gemma(rank, src):
    """27(b) on one rank of 4x1: gemma-2b's state drawn whole and cut into
    this rank's blocks (the ranks in turn), its held bytes, one FSDP step
    over its sequence, timed, its layer gathers and its peak."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    cfg = gemma_tp_cfg(get_config)
    mesh = card_mesh((4, 1))
    opt = adamw(TP_LR)
    for turn in range(mesh.size):   # one whole draw on the card at a time
        if turn == rank:
            state = TL.init_sharded_state(TP_SEED, cfg, opt, mesh, "cuda")
            torch.cuda.empty_cache()
        dist.barrier()
    held = {"params": tree_nbytes(state["params"]),
            "m": tree_nbytes(state["opt"]["m"]),
            "v": tree_nbytes(state["opt"]["v"]),
            "t": tree_nbytes(state["opt"]["t"]),
            "step": tree_nbytes(state["step"])}
    step = TL.make_train_step(cfg, opt, mesh=mesh)
    batch = tp_tokens(cfg.vocab, *GEMMA_BATCH,
                      rows=local_rows(mesh, GEMMA_BATCH[0]))
    torch.cuda.reset_peak_memory_stats()
    state, mets, ms = timed_step(step, state, batch)
    loss = mesh.all_reduce(mets["loss"].reshape(1), "data") / mesh.size
    return {"coords": dict(mesh.coords), "held": held, "ms": ms,
            "loss": float(loss), "grad_norm": float(mets["grad_norm"]),
            "layer_gathers": step.numeric.counts["layer_gathers"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


@contextlib.contextmanager
def first_read_recorded(K, first, fault):
    """Record the step's first shard-local read (layer 0's ``wqkv``,
    forward): its drive and its output.  With ``fault`` this rank's own
    tile sum is dropped in that read (the planted fault)."""
    read, reduce = K.manual_collective_read, K._reduce_tiles_cuda

    def reduce_first(part, sc, transpose=False):
        y = reduce(part, sc, transpose)
        if fault and "dropped" not in first:
            first["dropped"] = True
            y = torch.zeros_like(y)
        return y

    def read_first(x, *args, **kw):
        if "y" in first:
            return read(x, *args, **kw)
        K._reduce_tiles_cuda = reduce_first
        try:
            y = read(x, *args, **kw)
        finally:
            K._reduce_tiles_cuda = reduce
        first["x"], first["y"], first["g"] = x.clone(), y.clone(), args[0]
        return y
    K.manual_collective_read = read_first
    try:
        yield
    finally:
        K.manual_collective_read = read


def tp_rank_inexact(rank, src):
    """27(c) on one rank of 2x4: lm100m's device-mode step with phase 7's
    settings, exact, exact=False, and exact=False with the planted fault
    (rank ``FAULT_RANK``'s tile sum dropped in the first read), from the
    same state, batch and write seed; the conductances after each (rank
    0), the launches, and the first read of each against the exact
    step's (rank 0: its drive, and each form's output)."""
    from repro_torch.configs import get_config
    from repro_torch.core import shardctx
    from repro_torch.kernels import xbar_update as U
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.train import analog_lm as TA
    cfg = tp_inexact_cfg(get_config)
    mesh = card_mesh(INEXACT_LAYOUT)
    shardctx.set_shard_context(mesh, None)
    batch = tp_tokens(cfg.vocab, *TP_BATCH)
    out, firsts = {}, {}
    for run in ("exact", "inexact", "fault"):
        step = TA.make_analog_sgd_step(cfg, lr=0.1, mesh=mesh,
                                       exact=run == "exact")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        state = step.shard_state(TA.init_state(gen, cfg, device="cuda"))
        torch.cuda.empty_cache()
        for name in K.LAUNCHES:
            K.LAUNCHES[name] = 0
        for name in U.LAUNCHES:
            U.LAUNCHES[name] = 0
        firsts[run] = first = {}
        with first_read_recorded(K, first,
                                 run == "fault" and rank == FAULT_RANK):
            state, mets, ms = timed_step(step, state, batch,
                                         INEXACT_SEED_BASE)
        launches = {**K.LAUNCHES, **U.LAUNCHES}
        whole = step.unshard_state(state)["params"]
        gs = {"/".join(p): t.cpu() for p, t in leaves_of(whole)
              if p[-1] == "g"} if rank == 0 else None
        out[run] = {"loss": float(mets["loss"]), "ms": ms,
                    "launches": launches, "g": gs,
                    "first_block": tuple(first["g"].shape)}
        if rank == 0:
            out[run]["first"] = (first["x"].cpu(), first["y"].cpu())
        del state, whole, first["g"]
    return out


# --------------------------------------------------------------------------
# Phase 28: tensor and expert parallelism of the MoE family
# --------------------------------------------------------------------------

#: 28(a) / 28(c): deepseek-v2-lite at full width cut to this many layers
#: (the dry run reckons the 1x1 step at 46 GB and each rank of the
#: layouts at well under 20: the phase prints its reckoning), its layouts
#: and seed; the global batch is 27(a)'s, 8 x 256 tokens.
MOE_LAYERS = 1
MOE_LAYOUTS = ((2, 2), (1, 4), (4, 1))
MOE_SEED = 28
#: 28(c): its layout and a capacity factor at which the 1x1 dispatch
#: drops pairs (capacity 192 rows an expert for 2048 x 6 pairs over 64
#: experts: the mean load)
MOE_DROP_LAYOUT = (4, 1)
MOE_DROP_CF = 1.0
#: 28(b): llama4-scout at full width, one layer, over 4 x 1024 tokens,
#: on 1x4 with sgd: with adamw the dry run reckons 31.97 GB a rank on
#: 1x4 (12.81 held, the update's new m and v beside the old) and 63.93
#: on 1x2, 128 GB for the ranks together either way; sgd holds the
#: parameters' blocks alone (4.27 GB a rank)
SCOUT_BATCH = (4, 1024)
SCOUT_LAYOUT = (1, 4)
#: the 1x1 step's parameters, written for the ranks (6.6 GB: the card's
#: room is the ranks'; the dry run reckons 16.6 GB a rank on 4x1)
MOE_REF = ROOT / "build" / "phase28-ref.pt"


def moe_qat_cfg(get_config, **kw):
    """28(a)'s cut: deepseek-v2-lite, QAT at 128-row tiles (``wo`` splits
    by rows on 2x2 and 1x4), float32."""
    return get_config("deepseek-v2-lite-16b").replace(
        n_layers=MOE_LAYERS, dtype="float32", analog=True,
        analog_mode="fakequant", analog_rows=128, **kw)


def scout_cfg(get_config):
    return get_config("llama4-scout-17b-a16e").replace(n_layers=1)


@contextlib.contextmanager
def plain_counted(K, calls):
    """Count calls of the fakequant read's plain versions (whole, lead,
    split halves); the QAT backward's VJP of the eager expression is the
    design's own and not among them."""
    names = ("_fakequant_plain", "_fakequant_plain_lead",
             "_fakequant_plain_head", "_fakequant_plain_finish")
    saved = {n: getattr(K, n) for n in names}

    def counted(name):
        def call(*args, **kw):
            calls.append(name)
            return saved[name](*args, **kw)
        return call
    for n in names:
        setattr(K, n, counted(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(K, n, f)


def save_leaves(tree, path):
    """``tree``'s leaves, on the host, to ``path`` (for the ranks: the
    card keeps its room for them)."""
    path.parent.mkdir(exist_ok=True)
    torch.save({"/".join(p): t.detach().cpu() for p, t in leaves_of(tree)},
               path)


def draw_in_turns(make, rank, world):
    """``make()`` on each rank in turn: one whole draw on the card at a
    time (the state is drawn whole, then cut to the rank's blocks)."""
    import torch.distributed as dist
    out = None
    for turn in range(world):
        if turn == rank:
            out = make()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def params_against(S, params, npar, ref, compare):
    """Every leaf of this rank's blocks gathered whole (one leaf at a
    time, every rank taking part) and, with ``compare``, held against the
    1x1 step's (``ref``, on the host) in satellite 1's class: (elements
    off, elements, worst move off, by leaf)."""
    off = total = 0
    worst = 0.0
    by_leaf = {}
    for path, t in leaves_of(params):
        key = "/".join(path)
        spec = tree_get(npar.specs, path)
        whole = t if not spec or not any(spec) else S.leaf_unshard(
            t, path, spec, npar.cfg, npar.mesh,
            tree_get(npar.like, path).shape)
        if compare:
            w = ref[key].to(whole.device)
            d = (whole - w).abs()
            bad = d > 1e-5 * w.abs() + 1e-6
            n_bad = int(bad.sum())
            off += n_bad
            total += w.numel()
            if n_bad:
                worst = max(worst, float(d[bad].max()))
                by_leaf[key] = (n_bad, w.numel())
        del whole
    return off, total, worst, by_leaf


def expert_read_case(K, OPS, mesh, npar, cfg, adc):
    """A data rank's rows of an expert-stack read at 28(a)'s shapes (this
    rank's experts of deepseek-v2-lite's ``w_up``, 2048 x 1408, each
    expert's buffer 240 rows over the data ranks, this rank's share of
    them, 60 or 120 rows, as the global dispatch's buffer holds them):
    each expert's DAC scale the max over the data ranks
    (``kernels.ops.fakequant_expert_project``, the kernel's lead form
    with ``sc_in``) on the whole buffer's instance (the tensor cores: 240
    rows, where 60 would take the FP32 one); its rows bit-equal to the
    whole buffer's read, and against the plain lead version at the same
    scales in fq_agrees' class, expert by expert.  Times the kernel and
    its plain version on this rank's buffer."""
    from repro_torch.core.analog_registry import expert_capacity
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    rows = cfg.analog_rows
    e_l = npar.expert_range(cfg.n_experts)[1]
    n_d, d = npar.n_data, npar.data_index()
    t_all = TP_BATCH[0] * TP_BATCH[1]
    cap = expert_capacity(t_all, cfg)
    local = c = cap // n_d
    k, n = cfg.d_model, cfg.d_ff_expert
    x = torch.randn((e_l, cap, k), generator=gen, device="cuda")
    w = torch.randn((e_l, k, n), generator=gen, device="cuda") / math.sqrt(k)
    mine = x[:, d * c:(d + 1) * c].contiguous()
    inst = K.fakequant_instance(cap, adc.in_levels)
    with torch.no_grad():
        y = OPS.fakequant_expert_project(mine, w, adc, rows, mesh, npar.fsdp,
                                         cap)
        whole = K.fakequant_read(x, w, adc, rows)
        sc = K.fakequant_scale(mine, adc.in_levels)
        for a in npar.fsdp:
            sc = mesh.all_reduce(sc, a, op="max")
        y_p = K._fakequant_plain_lead(mine, w, sc, adc, rows)
    equal = bool(torch.equal(y[:, :c], whole[:, d * c:(d + 1) * c]))
    scale_equal = bool(torch.equal(sc, K.fakequant_scale(x, adc.in_levels)))
    ok, err, ratio, share = True, 0.0, 0.0, 0.0
    for i in range(e_l):
        o, e_, r_, s_ = fq_agrees(y[i], y_p[i], mine[i], w[i], sc[i:i + 1],
                                  adc, rows)
        ok, err = ok and o, max(err, e_)
        ratio, share = max(ratio, r_), max(share, s_)
    sync = torch.cuda.synchronize
    before = (K.LAUNCHES["fakequant"], K.LAUNCHES["fakequant_lead"])

    def kernel(i=0):
        return K.fakequant_read(mine, w, adc, rows, sc=sc, instance=inst)

    def plain(i=0):
        return K._fakequant_plain_lead(mine, w, sc, adc, rows)
    ms = cuda_ms(kernel, 5, sync)
    plain_ms = cuda_ms(plain, 2, sync)
    # timing launches not counted
    K.LAUNCHES["fakequant"], K.LAUNCHES["fakequant_lead"] = before
    b = fq_bounds(e_l * local, k, n)
    # every expert's W read once, not one W for all rows
    w_extra = 4 * (e_l - 1) * k * n / HBM_BYTES_PER_S
    t_bytes = 1e-3 * b["bytes_ms"] + w_extra
    t_ops = 2 * e_l * local * k * n / FP32_FLOPS
    return {"ok": ok, "bit_equal_whole_rows": equal,
            "scale_equal_whole": scale_equal, "max_abs_err": err,
            "worst_err_over_bound": ratio, "flip_share": share,
            "E": e_l, "T": local, "T_whole": cap, "rows_mine": c, "K": k,
            "N": n, "instance": inst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "tc_floor_ms": max(1e3 * t_bytes, 3e3 * 2 * e_l * local * k * n
                               / BF16_FLOPS)}


def moe_drop_case(M, moe, NP, shardctx, cfg, params, batch, mesh):
    """28(c) on one rank: the forward of the global batch at
    MOE_DROP_CF (no gradient, so the dispatch runs once a layer): the
    global loss and this rank's dropped pairs."""
    npar = NP(cfg, mesh)
    moe.DROPPED["pairs"] = 0
    with torch.no_grad(), shardctx.numeric_parallel(npar):
        loss = M.loss_fn(params, batch, cfg)[0]
    loss = mesh.all_reduce(loss.reshape(1), "data") / mesh.shape["data"]
    return {"loss": float(loss), "dropped": int(moe.DROPPED["pairs"])}


def moe_rank_qat(rank, src):
    """28(a) and 28(c) on one rank: for each layout, deepseek-v2-lite's
    cut drawn whole in turns and cut to this rank's blocks; on 4x1 first
    28(c)'s forward; one warm-up step and one timed QAT step (its launches
    counted, the plain versions' calls counted), the parameters held
    against the 1x1 step's leaf by leaf (rank 0), the expert-stack read
    (data ranks) and MLA's split and tiles reads (model ranks)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import shardctx
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.launch import sharding as S
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    cfg = moe_qat_cfg(get_config)
    adc = AdcConfig(in_bits=cfg.analog_in_bits, out_bits=cfg.analog_out_bits)
    ref = torch.load(MOE_REF, mmap=True) if rank == 0 else None
    world = dist.get_world_size()
    out = {}
    for shape in MOE_LAYOUTS:
        mesh = card_mesh(shape)
        opt = adamw(TP_LR)
        state = draw_in_turns(lambda: TL.init_sharded_state(
            MOE_SEED, cfg, opt, mesh, "cuda"), rank, world)
        step = TL.make_train_step(cfg, opt, mesh=mesh)
        npar = step.numeric
        batch = tp_tokens(cfg.vocab, *TP_BATCH,
                          rows=local_rows(mesh, TP_BATCH[0]))
        res = {}
        if shape == MOE_DROP_LAYOUT:
            res["drop"] = moe_drop_case(
                M, moe, S.NumericParallel, shardctx,
                cfg.replace(capacity_factor=MOE_DROP_CF), state["params"],
                batch, mesh)
        step(state, batch)      # warm-up (the step leaves its input state)
        for name in K.LAUNCHES:
            K.LAUNCHES[name] = 0
        calls = []
        torch.cuda.reset_peak_memory_stats()
        before = collective_bytes()
        with plain_counted(K, calls):
            state, mets, ms = timed_step(step, state, batch)
        launches = dict(K.LAUNCHES)
        moved = collective_bytes(before)
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss = mesh.all_reduce(mets["loss"].reshape(1), "data") \
            / mesh.shape["data"]
        off, total, worst, by_leaf = params_against(
            S, state["params"], npar, ref, rank == 0)
        res.update({
            "loss": float(loss), "grad_norm": float(mets["grad_norm"]),
            "ms": ms, "launches": launches, "plain_calls": len(calls),
            "plan": npar.plan(), "peak_gb": peak, "collective_bytes": moved,
            "params_off": off, "params": total, "params_worst": worst,
            "params_by_leaf": by_leaf})
        del state
        torch.cuda.empty_cache()
        if npar.n_data > 1:
            res["expert"] = expert_read_case(K, OPS, mesh, npar, cfg, adc)
        if mesh.shape["model"] > 1:
            h = cfg.n_heads
            res["split"] = split_read_case(
                K, mesh, cfg, adc, cfg.d_model,
                h * (cfg.qk_nope_dim + cfg.qk_rope_dim))
            res["tiles"] = tiles_read_case(K, mesh, cfg, adc,
                                           h * cfg.v_head_dim)
        out[shape] = res
        torch.cuda.empty_cache()
    return out


def scout_rank(rank, src, shape):
    """28(b) on one rank: llama4-scout's one-layer state (sgd: the
    parameters alone) drawn whole in turns and cut to this rank's blocks,
    its held bytes, one digital FSDP + TP + EP step over its rows, timed,
    its layer gathers and peak."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import sgd
    cfg = scout_cfg(get_config)
    mesh = card_mesh(shape)
    opt = sgd(TP_LR)
    state = draw_in_turns(lambda: TL.init_sharded_state(
        TP_SEED, cfg, opt, mesh, "cuda"), rank, dist.get_world_size())
    held = {"params": tree_nbytes(state["params"]),
            "opt": tree_nbytes(state["opt"]),
            "step": tree_nbytes(state["step"])}
    step = TL.make_train_step(cfg, opt, mesh=mesh)
    batch = tp_tokens(cfg.vocab, *SCOUT_BATCH,
                      rows=local_rows(mesh, SCOUT_BATCH[0]))
    torch.cuda.reset_peak_memory_stats()
    state, mets, ms = timed_step(step, state, batch)
    loss = mesh.all_reduce(mets["loss"].reshape(1), "data") \
        / mesh.shape["data"]
    return {"coords": dict(mesh.coords), "held": held, "ms": ms,
            "loss": float(loss), "grad_norm": float(mets["grad_norm"]),
            "layer_gathers": step.numeric.counts["layer_gathers"],
            "plan": step.numeric.plan(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_moe_qat(M, K, TL, TO, get_config, report, gpu_line,
                  keep_ref=False, then=()):
    """28(a) and 28(c): deepseek-v2-lite at full width (d 2048, 16 MLA
    heads, 64 experts of 2048 x 1408 top-6, 2 shared, vocab 102400) cut
    to MOE_LAYERS layers, QAT at 128-row tiles, 8 x 256 tokens: one FSDP
    + TP + EP step on 2x2, 1x4 and 4x1 (each rank its own process on this
    card) against the 1x1 step on the card from the same state.  Gates
    (28(a)): the loss within 1e-4 relative; the parameters in satellite
    1's class (off under 1e-3 of the elements, by at most 2 lr); each
    data rank's expert-stack read with the shared per-expert scale
    bit-equal to the whole buffer's read at the same rows and in
    fq_agrees' class against its plain version; MLA's split (``wq``)
    and tiles (``wo``) reads bit-equal to the whole read and in its class;
    each rank's fakequant reads and expert-stack reads equal to the 1x1
    step's, split reads on model ranks, and no plain-version call; the
    plan printed per layout (``ep``, ``mla`` and ``attn_row``, ``ffn``,
    ``vocab`` on model ranks).  28(c) at capacity factor MOE_DROP_CF on
    4x1: the 1x1 forward drops pairs, the loss within 1e-4 relative of
    its, and the four ranks' dropped pairs sum to its count.  With
    ``keep_ref`` the 1x1 step's parameters stay in MOE_REF for phase 30
    (which removes them); the jobs ``then`` run in the ranks' processes
    after 28(a)'s (:func:`spawn_layout`)."""
    from repro_torch.models import moe
    cfg = moe_qat_cfg(get_config)
    opt = TO.adamw(TP_LR)
    state = TL.init_state(MOE_SEED, cfg, opt, "cuda")
    batch = tp_tokens(cfg.vocab, *TP_BATCH)
    drop_cfg = cfg.replace(capacity_factor=MOE_DROP_CF)
    moe.DROPPED["pairs"] = 0
    with torch.no_grad():
        drop_loss = float(M.loss_fn(state["params"], batch, drop_cfg)[0])
    drop_one = {"loss": drop_loss, "dropped": int(moe.DROPPED["pairs"])}
    step = TL.make_train_step(cfg, opt)
    step(state, batch)          # warm-up (the step leaves its input state)
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats()
    state, mets, ms1 = timed_step(step, state, batch)
    one = {"loss": float(mets["loss"]), "ms": ms1,
           "grad_norm": float(mets["grad_norm"]),
           "reads": K.LAUNCHES["fakequant"],
           "lead_reads": K.LAUNCHES["fakequant_lead"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    save_leaves(state["params"], MOE_REF)
    del state
    try:
        ranks = spawn_layout(4, "moe", then)
    finally:
        if not keep_ref:
            MOE_REF.unlink(missing_ok=True)
    if not one["lead_reads"]:
        fail("28(a): the 1x1 step read no expert stack")
    if not drop_one["dropped"]:
        fail("28(c): the 1x1 forward drops no pair at capacity factor "
             f"{MOE_DROP_CF}")
    rows = []
    for shape_ in MOE_LAYOUTS:     # every layout's figures before the gates
        per = [r[shape_] for r in ranks]
        print(f"28(a) {shape_}: losses {[r['loss'] for r in per]}, grad "
              f"norms {[r['grad_norm'] for r in per]}, parameters off "
              f"{per[0]['params_off']} of {per[0]['params']} (by leaf "
              f"{per[0]['params_by_leaf']})", flush=True)
    for shape_ in MOE_LAYOUTS:
        label = "x".join(map(str, shape_))
        per = [r[shape_] for r in ranks]
        for i, r in enumerate(per):
            if abs(r["loss"] - one["loss"]) > 1e-4 * abs(one["loss"]):
                fail(f"28(a) {label} rank {i}: loss {r['loss']} against the "
                     f"1x1 step's {one['loss']}")
            lc = r["launches"]
            if lc["fakequant"] != one["reads"] \
                    or lc["fakequant_lead"] != one["lead_reads"]:
                fail(f"28(a) {label} rank {i}: {lc['fakequant']} fakequant "
                     f"reads ({lc['fakequant_lead']} expert stacks), the 1x1 "
                     f"step {one['reads']} ({one['lead_reads']})")
            if r["plain_calls"]:
                fail(f"28(a) {label} rank {i}: {r['plain_calls']} calls of "
                     "a plain version in the step")
            want = shape_[1] > 1
            plan = r["plan"]
            if not all(plan[k] == want for k in ("ep", "mla", "attn_row",
                                                 "ffn", "vocab")):
                fail(f"28(a) {label}: plan {plan}")
            if "expert" in r:
                ex = r["expert"]
                if not (ex["ok"] and ex["bit_equal_whole_rows"]
                        and ex["scale_equal_whole"]):
                    fail(f"28(a) {label} rank {i}: the expert-stack read is "
                         f"off the whole buffer's or its plain version: {ex}")
            if want:
                for case in ("split", "tiles"):
                    if not r[case]["ok"] \
                            or not r[case]["bit_equal_whole_read"]:
                        fail(f"28(a) {label} rank {i}: MLA's {case} read is "
                             f"off its plain version or the whole read: "
                             f"{r[case]}")
                if not lc["fakequant_split"]:
                    fail(f"28(a) {label} rank {i}: no split read in the "
                         f"step ({lc})")
        off, total, worst = (per[0]["params_off"], per[0]["params"],
                             per[0]["params_worst"])
        if off > 1e-3 * total or worst > 2 * TP_LR * 1.01:
            fail(f"28(a) {label}: {off} of {total} parameters off the 1x1 "
                 f"step's class (worst {worst:.3g}; by leaf "
                 f"{per[0]['params_by_leaf']})")
        row = {"layout": label, "loss": per[0]["loss"],
               "losses_per_rank": [r["loss"] for r in per],
               "loss_1x1": one["loss"], "grad_norm": per[0]["grad_norm"],
               "grad_norm_1x1": one["grad_norm"],
               "ms_per_rank": [r["ms"] for r in per], "ms_1x1": one["ms"],
               "peak_gb_per_rank": [r["peak_gb"] for r in per],
               "peak_gb_1x1": one["peak_gb"],
               "reads_per_rank": one["reads"],
               "expert_reads_per_rank": one["lead_reads"],
               "split_reads_per_rank": [r["launches"]["fakequant_split"]
                                        for r in per],
               "tiles_reads_per_rank": [r["launches"]["fakequant_tiles"]
                                        for r in per],
               "collective_bytes_per_rank": [r["collective_bytes"]
                                             for r in per],
               "params_off": off, "params": total, "plan": per[0]["plan"],
               "expert": [r["expert"] for r in per if "expert" in r],
               "split": [r["split"] for r in per if "split" in r],
               "tiles": [r["tiles"] for r in per if "tiles" in r]}
        ex = (f"expert read rank 0: {row['expert'][0]['ms']:.3f} ms (plain "
              f"{row['expert'][0]['plain_ms']:.3f}, bound "
              f"{row['expert'][0]['bound_ms']:.3f}), rows bit-equal to the "
              f"whole buffer's") if row["expert"] else "no data split"
        print(f"28(a) {label}: loss {row['loss']!r} (1x1 {one['loss']!r}), "
              f"grad norm {row['grad_norm']!r} (1x1 {one['grad_norm']!r}), "
              f"step ms per rank {[round(v, 1) for v in row['ms_per_rank']]}"
              f" (1x1 {one['ms']:.1f}; warm steps; each rank its own "
              f"process on this card), peak GB per rank "
              f"{[round(v, 2) for v in row['peak_gb_per_rank']]} (1x1 "
              f"{one['peak_gb']:.2f}), {one['reads']} fakequant reads a rank "
              f"({one['lead_reads']} expert stacks, "
              f"{row['split_reads_per_rank'][0]} split-range, "
              f"{row['tiles_reads_per_rank'][0]} tiles), {off} of {total} "
              f"parameters off; plan {row['plan']}; {ex} [{gpu_line}]")
        report(row)
        rows.append(row)
    drop = [r[MOE_DROP_LAYOUT]["drop"] for r in ranks]
    total_drop = sum(d["dropped"] for d in drop)
    if total_drop != drop_one["dropped"]:
        fail(f"28(c): the ranks drop {[d['dropped'] for d in drop]} pairs, "
             f"{total_drop} in all; the 1x1 forward {drop_one['dropped']}")
    for i, d in enumerate(drop):
        if abs(d["loss"] - drop_one["loss"]) > 1e-4 * abs(drop_one["loss"]):
            fail(f"28(c) rank {i}: loss {d['loss']} against the 1x1 "
                 f"forward's {drop_one['loss']}")
    drop_row = {"capacity_factor": MOE_DROP_CF, "layout": "4x1",
                "dropped_1x1": drop_one["dropped"],
                "dropped_per_rank": [d["dropped"] for d in drop],
                "loss_1x1": drop_one["loss"], "loss": drop[0]["loss"]}
    print(f"28(c) deepseek-v2-lite at capacity factor {MOE_DROP_CF} on 4x1: "
          f"{drop_one['dropped']} pairs dropped by the 1x1 forward of "
          f"{TP_BATCH[0] * TP_BATCH[1] * cfg.top_k * MOE_LAYERS} (pairs x "
          f"layers), the ranks {drop_row['dropped_per_rank']} (sum "
          f"{total_drop}); loss {drop[0]['loss']!r} (1x1 "
          f"{drop_one['loss']!r}) [{gpu_line}]")
    report(drop_row)
    return rows, drop_row


def phase_moe_scout(M, TL, DR, S, TM, get_config, report, gpu_line):
    """28(b): llama4-scout at full width (d 5120, 40 heads over 8 kv
    heads, 16 experts of 5120 x 8192, vocab 202048), one layer, digital
    bfloat16, FSDP + TP + EP on SCOUT_LAYOUT with sgd (adamw's state
    and its update do not fit four ranks on one card: SCOUT_LAYOUT's
    note), each rank its own process on this card, after the 1x1
    forward's loss from the same parameters (freed first: the 1x1 step
    does not fit one card), over 4 x 1024 tokens.  Gates: each rank's
    held parameter bytes equal the dry run's policy bytes for its
    coordinates, exactly, and it holds no optimizer state; a finite loss
    within 1e-2 relative of the 1x1 forward's; 2 layer gathers a rank
    (the forward and the rematted backward); ``ep`` and ``attn`` in the
    plan."""
    cfg = scout_cfg(get_config)
    layout = SCOUT_LAYOUT
    label = "x".join(map(str, layout))
    params = M.init_params(cfg, TP_SEED, "cuda")
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.no_grad():
        ev[0].record()
        loss, _ = M.loss_fn(params, tp_tokens(cfg.vocab, *SCOUT_BATCH), cfg)
        ev[1].record()
    torch.cuda.synchronize()
    one = {"loss": float(loss), "ms": ev[0].elapsed_time(ev[1]),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, loss
    ranks = spawn_layout(layout[0] * layout[1], f"scout{label}")
    like = M.init_params(cfg, None, "meta")
    n = layout[0] * layout[1]
    for i, r in enumerate(ranks):
        mesh = TM.Mesh(layout, ("data", "model"),
                       coords=(r["coords"]["data"], r["coords"]["model"]))
        specs = S.params_shardings(like, cfg, mesh)
        policy = DR.block_bytes(like, specs, mesh)
        held = r["held"]
        if held["params"] != policy or held["opt"]:
            fail(f"28(b) rank {i}: holds {held}, the policy {policy} bytes "
                 "of parameters")
        if not math.isfinite(r["loss"]) \
                or abs(r["loss"] - one["loss"]) > 1e-2 * abs(one["loss"]):
            fail(f"28(b) rank {i}: loss {r['loss']}, the 1x1 forward's "
                 f"{one['loss']}")
        if r["layer_gathers"] != 2 * cfg.n_layers:
            fail(f"28(b) rank {i}: {r['layer_gathers']} layer gathers, "
                 f"expected {2 * cfg.n_layers}")
        if not (r["plan"]["ep"] and r["plan"]["attn"]):
            fail(f"28(b) rank {i}: plan {r['plan']}")
    row = {"layout": label, "ranks": n,
           "tokens": f"{SCOUT_BATCH[0]} x {SCOUT_BATCH[1]}",
           "loss": ranks[0]["loss"], "loss_1x1": one["loss"],
           "ms_per_rank": [r["ms"] for r in ranks], "ms_1x1": one["ms"],
           "held_bytes_per_rank": ranks[0]["held"],
           "peak_gb_per_rank": [r["peak_gb"] for r in ranks],
           "peak_gb_1x1": one["peak_gb"], "plan": ranks[0]["plan"],
           "layer_gathers": ranks[0]["layer_gathers"]}
    print(f"28(b) llama4-scout {label} FSDP + TP + EP over {row['tokens']} "
          f"tokens, 1 layer: loss {row['loss']:.5f} (1x1 {one['loss']:.5f}),"
          f" step ms per rank {[round(v, 1) for v in row['ms_per_rank']]} "
          f"(1x1 forward {one['ms']:.1f}), held "
          f"{sum(ranks[0]['held'].values()) / 1e9:.3f} GB a rank (= the dry "
          f"run's policy), peak {max(row['peak_gb_per_rank']):.2f} GB a rank"
          f" (1x1 forward {one['peak_gb']:.2f}), {row['layer_gathers']} layer"
          f" gathers; plan {row['plan']} [{gpu_line}]")
    report(row)
    return row


# --------------------------------------------------------------------------
# Phase 29: tensor parallelism of the SSM, hybrid and cross-attention
# families
# --------------------------------------------------------------------------

#: 29(a)-(c): each model at full width cut to these depths (mamba2-1.3b 2
#: SSD layers; zamba2-1.2b 6, one application of the shared block;
#: whisper-medium 2 encoder and 2 decoder layers), QAT at 128-row tiles
#: over 27(a)'s 8 x 256 tokens (whisper's over 8 x 1500 frames), on
#: TP_LAYOUTS against the 1x1 step from the same state, and the seed
FAMILY_CASES = (("29(a)", "mamba2-1.3b", dict(n_layers=2)),
                ("29(b)", "zamba2-1.2b", dict(n_layers=6)),
                ("29(c)", "whisper-medium", dict(n_layers=2,
                                                 n_encoder_layers=2)))
FAMILY_SEED = 29
#: 29(d): llama-3.2-vision-90b at full width cut to one group (a cross
#: block and four self blocks), digital bfloat16 with sgd on 1x4 over 4 x
#: 1024 tokens and its 1024 vision tokens (28(b)'s setting)
VLM_TP_LAYERS = 5
VLM_TP_BATCH = (4, 1024)
VLM_TP_LAYOUT = (1, 4)


def family_ref(arch):
    """Where the 1x1 step's parameters of ``arch`` go for the ranks."""
    return ROOT / "build" / f"phase29-ref-{arch}.pt"


def family_cfg(get_config, arch, cut):
    return get_config(arch).replace(dtype="float32", analog=True,
                                    analog_mode="fakequant", analog_rows=128,
                                    **cut)


def family_batch(cfg, rows=None):
    """27(a)'s tokens, with whisper's frames (seeded normals, the global
    batch's, then ``rows``)."""
    batch = tp_tokens(cfg.vocab, *TP_BATCH, rows=rows)
    if cfg.family == "audio":
        extras = stream_extras(cfg, TP_BATCH[0], FAMILY_SEED)
        batch.update({k: v if rows is None else v[rows].contiguous()
                      for k, v in extras.items()})
    return batch


def family_plan(cfg):
    """The flags 29's plan must hold on ``model`` ranks."""
    on = {"vocab"}
    if cfg.ssm_state:
        on.add("ssm")
    if cfg.n_heads:
        on |= {"attn", "attn_row", "ffn", "ffn_row"}
    return on


def family_read_cases(K, S, mesh, cfg, adc):
    """29's split reads on a ``model`` rank at the step's shapes, each
    bit-equal to the whole read and against its plain version: the SSD
    layers' ``in_proj`` (its parts: z and x by heads, B, C and dt whole)
    and ``out_proj`` (tiles); the shared block's ``wqkv`` and ``w_upgate``
    (parts) and ``wo`` and ``w_down`` (tiles); the cross-attention's
    ``wqkv`` over this rank's sequences of 256 tokens and 1500 frames."""
    m = mesh.shape["model"]
    hd = cfg.resolved_head_dim
    out = {}
    if cfg.ssm_state:
        d_in, h, gn = S.ssm_dims(cfg)
        w_in = 2 * d_in + 2 * gn + h
        out["in_proj"] = split_read_case(
            K, mesh, cfg, adc, cfg.d_model, w_in,
            S.fused_parts(("in_proj",), w_in, cfg, m))
        out["out_proj"] = tiles_read_case(K, mesh, cfg, adc, d_in)
    if cfg.n_heads:
        w_qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        qkv = S.fused_parts(("wqkv",), w_qkv, cfg, m)
    if cfg.family == "hybrid":
        out["shared_wqkv"] = split_read_case(K, mesh, cfg, adc, cfg.d_model,
                                             w_qkv, qkv)
        out["shared_w_upgate"] = split_read_case(
            K, mesh, cfg, adc, cfg.d_model, 2 * cfg.d_ff,
            S.fused_parts(("w_upgate",), 2 * cfg.d_ff, cfg, m))
        out["shared_wo"] = tiles_read_case(K, mesh, cfg, adc,
                                           cfg.n_heads * hd)
        out["shared_w_down"] = tiles_read_case(K, mesh, cfg, adc, cfg.d_ff)
    if cfg.family == "audio":
        seqs = TP_BATCH[0] // mesh.shape["data"]
        out["cross_wqkv"] = split_read_case(
            K, mesh, cfg, adc, cfg.d_model, w_qkv, qkv,
            t=seqs * (TP_BATCH[1] + cfg.n_audio_frames))
    return out


def scan_probe(S, mesh, cfg):
    """29(a)'s scan probe on a ``model`` rank: the chunked SSD scan
    (``models.ssm._ssd_chunked``) of one layer at the step's shapes (this
    rank's 8 / data ranks sequences of 256 tokens, seeded normals) over
    all the heads and over this rank's heads alone, forward and backward:
    the rank's outputs, final states and its heads' input gradients
    against the all-heads scan's, bit for bit (the heads ride in the batch
    of the scan's strided products; their count differs)."""
    from repro_torch.models.ssm import _softplus, _ssd_chunked
    gen = torch.Generator(device="cuda")
    gen.manual_seed(FAMILY_SEED)
    d_in, h, _ = S.ssm_dims(cfg)
    m, r = mesh.shape["model"], mesh.coords["model"]
    b, s = TP_BATCH[0] // mesh.shape["data"], TP_BATCH[1]
    g, n, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    xh, dt = rnd(b, s, h, p), _softplus(rnd(b, s, h) - 4.0)
    bm, cm, dy = rnd(b, s, g, n), rnd(b, s, g, n), rnd(b, s, h, p)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    hr = h // m
    heads = slice(r * hr, (r + 1) * hr)

    def run(xh, dt, a_log, dy):
        xh, dt = xh.clone().requires_grad_(), dt.clone().requires_grad_()
        y, last = _ssd_chunked(xh, dt, a_log, bm, cm, cfg.ssm_chunk)
        dx, ddt = torch.autograd.grad(y, (xh, dt), dy)
        return y.detach(), last.detach(), dx, ddt
    whole = run(xh, dt, a_log, dy)
    mine = run(xh[:, :, heads].contiguous(), dt[..., heads].contiguous(),
               a_log[heads], dy[:, :, heads].contiguous())
    eq = {"y": torch.equal(mine[0], whole[0][:, :, heads]),
          "state": torch.equal(mine[1], whole[1][:, heads]),
          "dx": torch.equal(mine[2], whole[2][:, :, heads]),
          "ddt": torch.equal(mine[3], whole[3][..., heads])}
    err = float((mine[0] - whole[0][:, :, heads]).abs().max())
    return {"equal": eq, "y_max_abs_err": err, "heads": hr,
            "shape": [b, s, h, p]}


def family_rank(rank, src):
    """29(a)-(c) on one rank: for each model and layout, its cut drawn
    whole in turns and cut to this rank's blocks; one warm-up step and one
    timed QAT step (its launches counted, the plain versions' calls
    counted), the parameters held against the 1x1 step's leaf by leaf
    (rank 0); on ``model`` ranks the split and tiles reads and (the SSD
    models) the scan probe."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.launch import sharding as S
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    world = dist.get_world_size()
    out = {}
    for _, arch, cut in FAMILY_CASES:
        cfg = family_cfg(get_config, arch, cut)
        adc = AdcConfig(in_bits=cfg.analog_in_bits,
                        out_bits=cfg.analog_out_bits)
        ref = torch.load(family_ref(arch), mmap=True) if rank == 0 else None
        for shape in TP_LAYOUTS:
            mesh = card_mesh(shape)
            opt = adamw(TP_LR)
            state = draw_in_turns(lambda: TL.init_sharded_state(
                FAMILY_SEED, cfg, opt, mesh, "cuda"), rank, world)
            step = TL.make_train_step(cfg, opt, mesh=mesh)
            npar = step.numeric
            batch = family_batch(cfg, local_rows(mesh, TP_BATCH[0]))
            step(state, batch)      # warm-up (the step leaves its input)
            for name in K.LAUNCHES:
                K.LAUNCHES[name] = 0
            npar.counts.update(layer_gathers=0, norm_gather_bytes=0)
            calls = []
            torch.cuda.reset_peak_memory_stats()
            before = collective_bytes()
            with plain_counted(K, calls):
                state, mets, ms = timed_step(step, state, batch)
            launches, counts = dict(K.LAUNCHES), dict(npar.counts)
            moved = collective_bytes(before)
            peak = torch.cuda.max_memory_allocated() / 1e9
            loss = mesh.all_reduce(mets["loss"].reshape(1), "data") \
                / mesh.shape["data"]
            off, total, worst, by_leaf = params_against(
                S, state["params"], npar, ref, rank == 0)
            res = {"loss": float(loss), "grad_norm": float(mets["grad_norm"]),
                   "ms": ms, "launches": launches, "counts": counts,
                   "plain_calls": len(calls), "plan": npar.plan(),
                   "peak_gb": peak, "collective_bytes": moved,
                   "params_off": off, "params": total,
                   "params_worst": worst, "params_by_leaf": by_leaf}
            del state
            torch.cuda.empty_cache()
            if mesh.shape["model"] > 1:
                res["reads"] = family_read_cases(K, S, mesh, cfg, adc)
                if cfg.ssm_state:
                    res["scan"] = scan_probe(S, mesh, cfg)
            out[arch, shape] = res
            torch.cuda.empty_cache()
        del ref
    return out


def vlm_tp_cfg(get_config):
    return get_config("llama-3.2-vision-90b").replace(n_layers=VLM_TP_LAYERS)


def vlm_tp_batch(cfg, rows=None):
    batch = tp_tokens(cfg.vocab, *VLM_TP_BATCH, rows=rows)
    extras = stream_extras(cfg, VLM_TP_BATCH[0], FAMILY_SEED)
    batch.update({k: v if rows is None else v[rows].contiguous()
                  for k, v in extras.items()})
    return batch


def vlm_tp_rank(rank, src):
    """29(d) on one rank: the VLM's cut (sgd: the parameters alone) drawn
    whole in turns and cut to this rank's blocks, the cross gates set
    non-zero; its held bytes, one digital TP step over its rows, timed,
    its layer gathers and peak."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import sgd
    cfg = vlm_tp_cfg(get_config)
    mesh = card_mesh(VLM_TP_LAYOUT)
    opt = sgd(TP_LR)
    state = draw_in_turns(lambda: TL.init_sharded_state(
        TP_SEED, cfg, opt, mesh, "cuda"), rank, dist.get_world_size())
    set_cross_gates(state["params"], cfg)
    gates = [float(g) for p, v in leaves_of(state["params"])
             if p[-1] in CROSS_GATES for g in v.reshape(-1)]
    held = {"params": tree_nbytes(state["params"]),
            "opt": tree_nbytes(state["opt"]),
            "step": tree_nbytes(state["step"])}
    step = TL.make_train_step(cfg, opt, mesh=mesh)
    batch = vlm_tp_batch(cfg, local_rows(mesh, VLM_TP_BATCH[0]))
    torch.cuda.reset_peak_memory_stats()
    before = collective_bytes()
    state, mets, ms = timed_step(step, state, batch)
    moved = collective_bytes(before)
    loss = mesh.all_reduce(mets["loss"].reshape(1), "data") \
        / mesh.shape["data"]
    return {"coords": dict(mesh.coords), "held": held, "ms": ms,
            "loss": float(loss), "grad_norm": float(mets["grad_norm"]),
            "gates": gates, "collective_bytes": moved,
            "sp": step.numeric.sp_on,
            "layer_gathers": step.numeric.counts["layer_gathers"],
            "plan": step.numeric.plan(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_family_qat(K, TL, TO, get_config, report, gpu_line,
                     keep_ref=False, then=()):
    """29(a)-(c): mamba2-1.3b (d 2048, 64 SSD heads of 64, state 128, vocab
    50288 tied) at 2 layers, zamba2-1.2b (the same SSD layers at state 64,
    the shared block's 32 heads and d_ff 8192, vocab 32000) at 6 layers
    and whisper-medium (d 1024, 16 heads, d_ff 4096, vocab 51872) at 2 +
    2 layers, full width, QAT at 128-row tiles over 8 x 256 tokens
    (whisper's over 8 x 1500 frames), adamw: one FSDP + TP step on 2x2,
    1x4 and 4x1 (each rank its own process on this card) against the 1x1
    step on the card from the same state.  Gates: the loss within 1e-4
    relative; the parameters in satellite 1's class (off under 1e-3 of the
    elements, by at most 2 lr); each rank's fakequant reads in its step
    equal to the 1x1 step's, split-range and tiles reads among them on
    ``model`` ranks, and no plain-version call; the plan's flags
    (``family_plan``; none on 4x1) and the SSD norm's gather counted
    where ``ssm`` is on; on ``model`` ranks every split read of
    ``family_read_cases`` bit-equal to the whole read and in its plain
    version's class, and the scan probe bit-equal.  With ``keep_ref`` the
    1x1 steps' parameters stay in ``family_ref`` for phase 30 (which
    removes them); the jobs ``then`` run in the ranks' processes after
    29(a)-(c)'s (:func:`spawn_layout`)."""
    ones = {}
    for label, arch, cut in FAMILY_CASES:
        cfg = family_cfg(get_config, arch, cut)
        opt = TO.adamw(TP_LR)
        state = TL.init_state(FAMILY_SEED, cfg, opt, "cuda")
        step = TL.make_train_step(cfg, opt)
        batch = family_batch(cfg)
        step(state, batch)      # warm-up (the step leaves its input state)
        for name in K.LAUNCHES:
            K.LAUNCHES[name] = 0
        torch.cuda.reset_peak_memory_stats()
        state, mets, ms1 = timed_step(step, state, batch)
        ones[arch] = {"loss": float(mets["loss"]), "ms": ms1,
                      "grad_norm": float(mets["grad_norm"]),
                      "reads": K.LAUNCHES["fakequant"],
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        save_leaves(state["params"], family_ref(arch))
        del state, step, batch
        torch.cuda.empty_cache()
    try:
        ranks = spawn_layout(4, "family", then)
    finally:
        for _, arch, _ in FAMILY_CASES if not keep_ref else ():
            family_ref(arch).unlink(missing_ok=True)
    for label, arch, _ in FAMILY_CASES:     # every figure before the gates
        for shape in TP_LAYOUTS:
            per = [r[arch, shape] for r in ranks]
            print(f"{label} {arch} {shape}: losses "
                  f"{[r['loss'] for r in per]}, grad norms "
                  f"{[r['grad_norm'] for r in per]}, parameters off "
                  f"{per[0]['params_off']} of {per[0]['params']} (by leaf "
                  f"{per[0]['params_by_leaf']}); scan probes "
                  f"{[r.get('scan', {}).get('equal') for r in per]}",
                  flush=True)
    rows = []
    for label, arch, cut in FAMILY_CASES:
        cfg = family_cfg(get_config, arch, cut)
        one = ones[arch]
        for shape in TP_LAYOUTS:
            lay = "x".join(map(str, shape))
            per = [r[arch, shape] for r in ranks]
            want = family_plan(cfg) if shape[1] > 1 else set()
            for i, r in enumerate(per):
                where = f"{label} {lay} rank {i}"
                if abs(r["loss"] - one["loss"]) > 1e-4 * abs(one["loss"]):
                    fail(f"{where}: loss {r['loss']} against the 1x1 "
                         f"step's {one['loss']}")
                lc = r["launches"]
                if lc["fakequant"] != one["reads"]:
                    fail(f"{where}: {lc['fakequant']} fakequant reads in "
                         f"its step, the 1x1 step {one['reads']}")
                if r["plain_calls"]:
                    fail(f"{where}: {r['plain_calls']} calls of a plain "
                         "version in the step")
                if {k for k, v in r["plan"].items() if v} != want:
                    fail(f"{where}: plan {r['plan']}, expected {want}")
                if ("ssm" in want) != (r["counts"]["norm_gather_bytes"] > 0):
                    fail(f"{where}: norm gather counts {r['counts']}")
                if shape[1] == 1:
                    continue
                if not lc["fakequant_split"] or not lc["fakequant_tiles"]:
                    fail(f"{where}: no split-range or tiles read in the "
                         f"step ({lc})")
                for name, case in r["reads"].items():
                    if not case["ok"] or not case["bit_equal_whole_read"]:
                        fail(f"{where}: the {name} read is off its plain "
                             f"version or the whole read: {case}")
                if "scan" in r and not all(r["scan"]["equal"].values()):
                    fail(f"{where}: the scan on the rank's heads is not the "
                         f"all-heads scan's: {r['scan']}")
            off, total, worst = (per[0]["params_off"], per[0]["params"],
                                 per[0]["params_worst"])
            if off > 1e-3 * total or worst > 2 * TP_LR * 1.01:
                fail(f"{label} {lay}: {off} of {total} parameters off the "
                     f"1x1 step's class (worst {worst:.3g}; by leaf "
                     f"{per[0]['params_by_leaf']})")
            row = {"case": label, "arch": arch, "layout": lay, **cut,
                   "loss": per[0]["loss"],
                   "losses_per_rank": [r["loss"] for r in per],
                   "loss_1x1": one["loss"], "grad_norm": per[0]["grad_norm"],
                   "grad_norm_1x1": one["grad_norm"],
                   "ms_per_rank": [r["ms"] for r in per], "ms_1x1": one["ms"],
                   "peak_gb_per_rank": [r["peak_gb"] for r in per],
                   "peak_gb_1x1": one["peak_gb"],
                   "reads_per_rank": one["reads"],
                   "split_reads_per_rank": [r["launches"]["fakequant_split"]
                                            for r in per],
                   "tiles_reads_per_rank": [r["launches"]["fakequant_tiles"]
                                            for r in per],
                   "norm_gather_bytes_per_rank": per[0]["counts"][
                       "norm_gather_bytes"],
                   "collective_bytes_per_rank": [r["collective_bytes"]
                                                 for r in per],
                   "layer_gathers_per_rank": per[0]["counts"][
                       "layer_gathers"],
                   "params_off": off, "params": total, "plan": per[0]["plan"],
                   "reads": [r.get("reads", {}) for r in per],
                   "scan": [r["scan"] for r in per if "scan" in r]}
            reads = ", ".join(
                f"{name} {c['ms']:.3f} ms (plain {c['plain_ms']:.3f})"
                for name, c in per[0].get("reads", {}).items()) \
                or "no model split"
            print(f"{label} {arch} {lay}: loss {row['loss']!r} (1x1 "
                  f"{one['loss']!r}), grad norm {row['grad_norm']!r} (1x1 "
                  f"{one['grad_norm']!r}), step ms per rank "
                  f"{[round(v, 1) for v in row['ms_per_rank']]} (1x1 "
                  f"{one['ms']:.1f}; warm steps; each rank its own process "
                  f"on this card), peak GB per rank "
                  f"{[round(v, 2) for v in row['peak_gb_per_rank']]} (1x1 "
                  f"{one['peak_gb']:.2f}), {one['reads']} fakequant reads a "
                  f"rank ({row['split_reads_per_rank'][0]} split-range, "
                  f"{row['tiles_reads_per_rank'][0]} tiles), SSD norm "
                  f"gather {row['norm_gather_bytes_per_rank'] / 1e6:.1f} MB "
                  f"a rank a step, {off} of {total} parameters off; rank 0's"
                  f" reads: {reads} [{gpu_line}]")
            report(row)
            rows.append(row)
    return rows


def phase_family_vlm(M, DR, S, TM, get_config, report, gpu_line):
    """29(d): llama-3.2-vision-90b at full width (d 8192, 64 heads over 8
    kv heads, d_ff 28672, vocab 128256) cut to VLM_TP_LAYERS layers (one
    cross block, four self blocks), digital bfloat16, TP on VLM_TP_LAYOUT
    with sgd, each rank its own process on this card, after the 1x1
    forward's loss from the same parameters with the same non-zero cross
    gates (freed first), over 4 x 1024 tokens and the 1024 vision tokens.
    Gates: the cross gates non-zero on every rank; each rank's held
    parameter bytes equal the dry run's reckoning for its coordinates
    (its policy bytes plus what the port holds beyond them), and it holds
    no optimizer state; a finite loss within 1e-2 relative of the 1x1
    forward's; the layer gathers (each self block twice under remat, the
    cross block once); ``attn``, ``attn_row``, ``ffn``, ``ffn_row`` and
    ``vocab`` in the plan."""
    from repro_torch.models.transformer import remat_policy
    cfg = vlm_tp_cfg(get_config)
    layout = VLM_TP_LAYOUT
    label = "x".join(map(str, layout))
    params = M.init_params(cfg, TP_SEED, "cuda")
    set_cross_gates(params, cfg)
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.no_grad():
        ev[0].record()
        loss, _ = M.loss_fn(params, vlm_tp_batch(cfg), cfg)
        ev[1].record()
    torch.cuda.synchronize()
    one = {"loss": float(loss), "ms": ev[0].elapsed_time(ev[1]),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, loss
    ranks = spawn_layout(layout[0] * layout[1], "vlm1x4")
    like = M.init_params(cfg, None, "meta")
    n_self = cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    gathers = n_self * (1 if remat_policy() == "none" else 2) \
        + cfg.n_layers // cfg.cross_attn_every
    for i, r in enumerate(ranks):
        mesh = TM.Mesh(layout, ("data", "model"),
                       coords=(r["coords"]["data"], r["coords"]["model"]))
        specs = S.params_shardings(like, cfg, mesh)
        policy = DR.block_bytes(like, specs, mesh)
        port = DR.tree_bytes(S.shard_tree(like, specs, cfg, mesh))
        held = r["held"]
        if held["params"] != port or held["opt"]:
            fail(f"29(d) rank {i}: holds {held}, the dry run reckons {port} "
                 f"bytes of parameters (policy {policy})")
        if not r["gates"] or not all(r["gates"]):
            fail(f"29(d) rank {i}: cross gates {r['gates']}")
        if not math.isfinite(r["loss"]) \
                or abs(r["loss"] - one["loss"]) > 1e-2 * abs(one["loss"]):
            fail(f"29(d) rank {i}: loss {r['loss']}, the 1x1 forward's "
                 f"{one['loss']}")
        if r["layer_gathers"] != gathers:
            fail(f"29(d) rank {i}: {r['layer_gathers']} layer gathers, "
                 f"expected {gathers}")
        if not all(r["plan"][k] for k in ("attn", "attn_row", "ffn",
                                            "ffn_row", "vocab")):
            fail(f"29(d) rank {i}: plan {r['plan']}")
    row = {"layout": label, "ranks": len(ranks), "layers": cfg.n_layers,
           "tokens": f"{VLM_TP_BATCH[0]} x {VLM_TP_BATCH[1]}",
           "vision_tokens": cfg.n_vision_tokens,
           "loss": ranks[0]["loss"], "loss_1x1": one["loss"],
           "ms_per_rank": [r["ms"] for r in ranks], "ms_1x1": one["ms"],
           "held_bytes_per_rank": ranks[0]["held"],
           "policy_bytes_rank0": policy, "port_bytes_rank0": port,
           "peak_gb_per_rank": [r["peak_gb"] for r in ranks],
           "peak_gb_1x1": one["peak_gb"], "plan": ranks[0]["plan"],
           "layer_gathers": ranks[0]["layer_gathers"],
           "collective_bytes_per_rank": [r["collective_bytes"]
                                         for r in ranks]}
    print(f"29(d) llama-3.2-vision-90b {label} TP over {row['tokens']} "
          f"tokens and {cfg.n_vision_tokens} vision tokens, {cfg.n_layers} "
          f"layers: loss {row['loss']:.5f} (1x1 forward {one['loss']:.5f}),"
          f" step ms per rank {[round(v, 1) for v in row['ms_per_rank']]} "
          f"(1x1 forward {one['ms']:.1f}), held "
          f"{sum(ranks[0]['held'].values()) / 1e9:.3f} GB a rank (= the dry "
          f"run's reckoning; policy {policy / 1e9:.3f}), peak "
          f"{max(row['peak_gb_per_rank']):.2f} GB a rank (1x1 forward "
          f"{one['peak_gb']:.2f}), {row['layer_gathers']} layer gathers; "
          f"plan {row['plan']} [{gpu_line}]")
    report(row)
    return row


#: Phase 30: ``REPRO_SEQ_SHARD`` on the MoE, SSM, hybrid and cross-attention
#: families, each case's QAT step under the flag on its layout against the
#: 1x1 step of phase 28(a) / 29(a)-(c) (its parameters kept for this
#: phase) and the same layout's step without the flag (its reads,
#: collective bytes, peak and ms from those phases' rows); 30(e) the VLM's
#: 29(d) step under the flag
SEQ_CASES = (("30(a)", "deepseek-v2-lite-16b", (2, 2)),
             ("30(a)", "deepseek-v2-lite-16b", (1, 4)),
             ("30(b)", "mamba2-1.3b", (1, 4)),
             ("30(c)", "zamba2-1.2b", (1, 4)),
             ("30(d)", "whisper-medium", (1, 4)))
SEQ_READ_SEED = 30


def seq_cfg(get_config, arch):
    """30's cut of ``arch``: 28(a)'s for deepseek-v2-lite, 29's for the
    others."""
    if arch == "deepseek-v2-lite-16b":
        return moe_qat_cfg(get_config)
    return family_cfg(get_config, arch,
                      next(c for _, a, c in FAMILY_CASES if a == arch))


@contextlib.contextmanager
def sequence_lengths(npar, seen):
    """Record each column-parallel read's input sequence length and its
    gathered one (``NumericParallel.col_input``) into ``seen``."""
    col = npar.col_input

    def recorded(x):
        y = col(x)
        seen.append((int(x.shape[1]), int(y.shape[1])))
        return y
    npar.col_input = recorded
    try:
        yield
    finally:
        del npar.col_input


def chunk_read_case(K, L, shardctx, mesh, npar, cfg, adc, k, n):
    """A whole leaf read on this rank's chunk of the sequence (MLA's
    ``wkv_a``, the hybrid's shared ``in``) at the step's shapes: seeded
    normals, the global batch's 8 x 256 tokens by ``k``, through ``k`` x
    ``n`` weights; this rank's rows and chunk read by
    ``models.layers.project`` under sequence parallelism (the DAC scale
    the max over the data and ``model`` ranks, the whole read's kernel
    instance) against the rows of the whole read, bit for bit.  Times
    both (the chunk read's scale exchange included)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEQ_READ_SEED)
    b, s = TP_BATCH
    x = torch.randn(b, s, k, generator=gen, device="cuda")
    w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    m, r = mesh.shape["model"], mesh.coords["model"]
    c = s // m
    rows = local_rows(mesh, b)
    mine = x[rows, r * c:(r + 1) * c].contiguous()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad():
        ev[0].record()
        whole = K.fakequant_read(x.reshape(-1, k), w, adc, cfg.analog_rows)
        ev[1].record()
        npar.sp_on = True
        with shardctx.numeric_parallel(npar):
            ev[2].record()
            y = L.project({"w": w}, mine, cfg, tp=L.SEQ)
            ev[3].record()
    torch.cuda.synchronize()
    want = whole.reshape(b, s, n)[rows, r * c:(r + 1) * c]
    return {"k": k, "n": n, "rows": int(mine.shape[0] * mine.shape[1]),
            "bit_equal_whole_rows": bool(torch.equal(y, want)),
            "max_abs_err": float((y - want).abs().max()),
            "ms": ev[2].elapsed_time(ev[3]),
            "whole_ms": ev[0].elapsed_time(ev[1])}


def seq_rank(rank, src):
    """30(a)-(e) on one rank under ``REPRO_SEQ_SHARD``: for each case its
    cut drawn whole in turns and cut to this rank's blocks; one warm-up
    step and one timed QAT step (its launches, the plain versions' calls,
    its collective bytes and each column-parallel read's sequence lengths
    recorded), the parameters held against the 1x1 step's leaf by leaf
    (rank 0), and the chunk read of MLA's ``wkv_a`` or the hybrid's shared
    ``in``; then 29(d)'s VLM step."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import shardctx
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.launch import sharding as S
    from repro_torch.models import layers as L
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    os.environ["REPRO_SEQ_SHARD"] = "1"
    t0 = time.perf_counter()
    world = dist.get_world_size()
    out = {}
    for label, arch, shape in SEQ_CASES:
        cfg = seq_cfg(get_config, arch)
        adc = AdcConfig(in_bits=cfg.analog_in_bits,
                        out_bits=cfg.analog_out_bits)
        moe = cfg.family == "moe"
        ref = torch.load(MOE_REF if moe else family_ref(arch), mmap=True) \
            if rank == 0 else None
        mesh = card_mesh(shape)
        opt = adamw(TP_LR)
        state = draw_in_turns(lambda: TL.init_sharded_state(
            MOE_SEED if moe else FAMILY_SEED, cfg, opt, mesh, "cuda"), rank,
            world)
        rows = local_rows(mesh, TP_BATCH[0])
        batch = tp_tokens(cfg.vocab, *TP_BATCH, rows=rows) if moe \
            else family_batch(cfg, rows)
        step = TL.make_train_step(cfg, opt, mesh=mesh)
        npar = step.numeric
        step(state, batch)      # warm-up (the step leaves its input state)
        for name in K.LAUNCHES:
            K.LAUNCHES[name] = 0
        calls, seen = [], []
        torch.cuda.reset_peak_memory_stats()
        before = collective_bytes()
        with plain_counted(K, calls), sequence_lengths(npar, seen):
            state, mets, ms = timed_step(step, state, batch)
        launches = dict(K.LAUNCHES)
        moved = collective_bytes(before)
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss = mesh.all_reduce(mets["loss"].reshape(1), "data") \
            / mesh.shape["data"]
        off, total, worst, by_leaf = params_against(
            S, state["params"], npar, ref, rank == 0)
        res = {"loss": float(loss), "grad_norm": float(mets["grad_norm"]),
               "ms": ms, "launches": launches, "plain_calls": len(calls),
               "plan": npar.plan(), "sp": npar.sp_on, "peak_gb": peak,
               "collective_bytes": moved,
               "seq_lengths": sorted(set(seen)),
               "params_off": off, "params": total, "params_worst": worst,
               "params_by_leaf": by_leaf}
        del state, ref
        torch.cuda.empty_cache()
        if moe:
            res["chunk_read"] = chunk_read_case(
                K, L, shardctx, mesh, npar, cfg, adc, cfg.d_model,
                cfg.kv_lora_rank + cfg.qk_rope_dim)
        elif cfg.family == "hybrid":
            res["chunk_read"] = chunk_read_case(
                K, L, shardctx, mesh, npar, cfg, adc, 2 * cfg.d_model,
                cfg.d_model)
        out[label, arch, shape] = res
        torch.cuda.empty_cache()
    out["vlm"] = vlm_tp_rank(rank, src)
    out["seconds"] = time.perf_counter() - t0
    return out


def seq_split_ok(lengths, cfg, m):
    """Whether a step's column-parallel reads saw the sequence split: the
    tokens' chunk (and whisper's frames') gathered whole, and no read's
    input a chunk left as it is (the MoE layer's shared experts read the
    gathered sequence's tokens, flattened: a dim 1 of ``d_model``)."""
    whole = {TP_BATCH[1]} | ({cfg.n_audio_frames}
                             if cfg.family == "audio" else set())
    chunks = {n // m for n in whole}
    return all((n // m, n) in lengths for n in whole) and all(
        b == a * m or (a == b and a not in chunks) for a, b in lengths)


def phase_seq(get_config, moe_rows, family_rows, vlm_row, report, gpu_line):
    """30: ``REPRO_SEQ_SHARD`` (Megatron sequence parallelism between the
    blocks) on deepseek-v2-lite's MOE_LAYERS-layer QAT step (MLA, EP, the
    global dispatch) on 2x2 and 1x4, mamba2's (2 layers), zamba2's (6) and
    whisper's (2 + 2, 8 x 1500 frames) on 1x4, full width at 128-row
    tiles over 8 x 256 tokens, each rank its own process on this card,
    and (30(e)) the VLM's 29(d) step on 1x4.  Gates: ``seq`` in the plan
    and on in the step, the sequence split (``seq_split_ok``); the loss
    within 1e-4 relative of the 1x1 step's (1e-2 of the 1x1 forward's for
    30(e), 29(d)'s class); the parameters in satellite 1's class (off
    under 1e-3 of the elements, by at most 2 lr); each rank's fakequant
    reads, split-range, tiles and expert-stack reads in its step equal to
    the same layout's without the flag (phases 28-29), and no
    plain-version call; the chunk reads (``wkv_a``, the shared ``in``)
    bit-equal to their rows of the whole read; 30(e)'s layer gathers
    equal to 29(d)'s.  Printed beside the same layout without the flag:
    the bytes each rank receives a step through the numeric step's
    collectives (``core.shardctx.GATHERED``), peak GB and step ms a
    rank."""
    try:
        ranks = spawn_layout(4, "seq30")
    finally:
        MOE_REF.unlink(missing_ok=True)
        for _, arch, _ in FAMILY_CASES:
            family_ref(arch).unlink(missing_ok=True)
    base = {("deepseek-v2-lite-16b", r["layout"]): r for r in moe_rows}
    base.update({(r["arch"], r["layout"]): r for r in family_rows})
    for label, arch, shape in SEQ_CASES:   # every figure before the gates
        per = [r[label, arch, shape] for r in ranks]
        print(f"{label} {arch} {shape} under REPRO_SEQ_SHARD: losses "
              f"{[r['loss'] for r in per]}, parameters off "
              f"{per[0]['params_off']} of {per[0]['params']} (by leaf "
              f"{per[0]['params_by_leaf']}), sequence lengths "
              f"{per[0]['seq_lengths']}", flush=True)

    def mb(d):
        return round(d.get("model", 0) / 1e6, 3)
    rows = []
    for label, arch, shape in SEQ_CASES:
        cfg = seq_cfg(get_config, arch)
        lay = "x".join(map(str, shape))
        b0 = base[arch, lay]
        per = [r[label, arch, shape] for r in ranks]
        for i, r in enumerate(per):
            where = f"{label} {arch} {lay} rank {i}"
            if not (r["plan"]["seq"] and r["sp"]):
                fail(f"{where}: seq {r['plan']['seq']}, on in the step "
                     f"{r['sp']}")
            if not seq_split_ok(r["seq_lengths"], cfg, shape[1]):
                fail(f"{where}: the column-parallel reads saw sequence "
                     f"lengths {r['seq_lengths']}")
            if abs(r["loss"] - b0["loss_1x1"]) > 1e-4 * abs(b0["loss_1x1"]):
                fail(f"{where}: loss {r['loss']} against the 1x1 step's "
                     f"{b0['loss_1x1']}")
            lc = r["launches"]
            want = {"fakequant": b0["reads_per_rank"],
                    "fakequant_split": b0["split_reads_per_rank"][i],
                    "fakequant_tiles": b0["tiles_reads_per_rank"][i]}
            if "expert_reads_per_rank" in b0:
                want["fakequant_lead"] = b0["expert_reads_per_rank"]
            if any(lc[k] != v for k, v in want.items()):
                fail(f"{where}: reads {lc}, without the flag {want}")
            if r["plain_calls"]:
                fail(f"{where}: {r['plain_calls']} calls of a plain version "
                     "in the step")
            if "chunk_read" in r and not r["chunk_read"][
                    "bit_equal_whole_rows"]:
                fail(f"{where}: the chunk read is off the whole read's rows:"
                     f" {r['chunk_read']}")
        off, total, worst = (per[0]["params_off"], per[0]["params"],
                             per[0]["params_worst"])
        if off > 1e-3 * total or worst > 2 * TP_LR * 1.01:
            fail(f"{label} {lay}: {off} of {total} parameters off the 1x1 "
                 f"step's class (worst {worst:.3g}; by leaf "
                 f"{per[0]['params_by_leaf']})")
        row = {"case": label, "arch": arch, "layout": lay,
               "loss": per[0]["loss"], "loss_1x1": b0["loss_1x1"],
               "loss_without": b0["loss"],
               "ms_per_rank": [r["ms"] for r in per],
               "ms_per_rank_without": b0["ms_per_rank"],
               "peak_gb_per_rank": [r["peak_gb"] for r in per],
               "peak_gb_per_rank_without": b0["peak_gb_per_rank"],
               "collective_bytes_per_rank": [r["collective_bytes"]
                                             for r in per],
               "collective_bytes_per_rank_without":
                   b0["collective_bytes_per_rank"],
               "reads_per_rank": per[0]["launches"]["fakequant"],
               "split_reads_per_rank": [r["launches"]["fakequant_split"]
                                        for r in per],
               "tiles_reads_per_rank": [r["launches"]["fakequant_tiles"]
                                        for r in per],
               "params_off": off, "params": total,
               "seq_lengths": per[0]["seq_lengths"],
               "chunk_read": [r["chunk_read"] for r in per
                              if "chunk_read" in r]}
        chunk = row["chunk_read"]
        ch = (f"; chunk read ({chunk[0]['rows']} of "
              f"{TP_BATCH[0] * TP_BATCH[1]} rows, {chunk[0]['k']} x "
              f"{chunk[0]['n']}) bit-equal on every rank, "
              f"{chunk[0]['ms']:.3f} ms against the whole read's "
              f"{chunk[0]['whole_ms']:.3f}") if chunk else ""
        print(f"{label} {arch} {lay} REPRO_SEQ_SHARD: loss {row['loss']!r} "
              f"(1x1 {b0['loss_1x1']!r}, without the flag "
              f"{b0['loss']!r}); model-axis collective MB a rank a step "
              f"{[mb(d) for d in row['collective_bytes_per_rank']]} "
              f"(without {[mb(d) for d in b0['collective_bytes_per_rank']]})"
              f"; peak GB a rank "
              f"{[round(v, 2) for v in row['peak_gb_per_rank']]} (without "
              f"{[round(v, 2) for v in b0['peak_gb_per_rank']]}); step ms a "
              f"rank {[round(v, 1) for v in row['ms_per_rank']]} (without "
              f"{[round(v, 1) for v in b0['ms_per_rank']]}; warm steps, "
              f"each rank its own process on this card); "
              f"{row['reads_per_rank']} fakequant reads a rank as without "
              f"the flag; {off} of {total} parameters off{ch} [{gpu_line}]")
        report(row)
        rows.append(row)
    print(f"30: the ranks' work took {max(r['seconds'] for r in ranks):.1f} "
          "s of wall time (in the processes it ran in)", flush=True)
    vlm = [r["vlm"] for r in ranks]
    for i, r in enumerate(vlm):
        where = f"30(e) rank {i}"
        if not (r["plan"]["seq"] and r["sp"]):
            fail(f"{where}: seq {r['plan']['seq']}, on in the step "
                 f"{r['sp']}")
        if not math.isfinite(r["loss"]) or abs(
                r["loss"] - vlm_row["loss_1x1"]) > 1e-2 * abs(
                vlm_row["loss_1x1"]):
            fail(f"{where}: loss {r['loss']}, the 1x1 forward's "
                 f"{vlm_row['loss_1x1']}")
        if r["layer_gathers"] != vlm_row["layer_gathers"]:
            fail(f"{where}: {r['layer_gathers']} layer gathers, without the "
                 f"flag {vlm_row['layer_gathers']}")
    vrow = {"case": "30(e)", "arch": "llama-3.2-vision-90b",
            "layout": vlm_row["layout"], "loss": vlm[0]["loss"],
            "loss_1x1": vlm_row["loss_1x1"], "loss_without": vlm_row["loss"],
            "ms_per_rank": [r["ms"] for r in vlm],
            "ms_per_rank_without": vlm_row["ms_per_rank"],
            "peak_gb_per_rank": [r["peak_gb"] for r in vlm],
            "peak_gb_per_rank_without": vlm_row["peak_gb_per_rank"],
            "collective_bytes_per_rank": [r["collective_bytes"] for r in vlm],
            "collective_bytes_per_rank_without":
                vlm_row["collective_bytes_per_rank"],
            "plan": vlm[0]["plan"]}
    print(f"30(e) llama-3.2-vision-90b {vrow['layout']} REPRO_SEQ_SHARD "
          f"(bfloat16 digital, sgd, {VLM_TP_LAYERS} layers): loss "
          f"{vrow['loss']:.5f} (1x1 forward {vlm_row['loss_1x1']:.5f}, "
          f"without the flag {vlm_row['loss']:.5f}); model-axis collective "
          f"MB a rank a step "
          f"{[mb(d) for d in vrow['collective_bytes_per_rank']]} (without "
          f"{[mb(d) for d in vlm_row['collective_bytes_per_rank']]}); peak "
          f"GB a rank {[round(v, 2) for v in vrow['peak_gb_per_rank']]} "
          f"(without "
          f"{[round(v, 2) for v in vlm_row['peak_gb_per_rank']]}); step ms "
          f"a rank {[round(v, 1) for v in vrow['ms_per_rank']]} (without "
          f"{[round(v, 1) for v in vlm_row['ms_per_rank']]}) [{gpu_line}]")
    report(vrow)
    return rows, vrow


def seq_launches(rows, case):
    """Phase 30's reads of one kind (``case``: ``fakequant``, ``split`` or
    ``tiles``) in each case's step, summed over the ranks."""
    out = {}
    for r in rows:
        key = f"{r['arch']} {r['layout']}"
        if case == "fakequant":
            out[key] = r["reads_per_rank"] * len(r["ms_per_rank"])
        else:
            out[key] = sum(r[f"{case}_reads_per_rank"])
    return out


# --------------------------------------------------------------------------
# Phase 32: serving under the sharding policy
# --------------------------------------------------------------------------

#: 32's models and the layouts each is served on after its one-device run
SERVE_ARCHS = (("gemma-2b", ((1, 4), (2, 2), (4, 1))),
               ("mamba2-1.3b", ((1, 4), (4, 1))),
               ("zamba2-1.2b", ((1, 4),)))
SERVE_MODES = ("digital", "fakequant")
SERVE_SEED = 32
#: prompts x tokens of the prefill, then SERVE_STEPS greedy decode steps
#: a model: gemma-2b's 16; mamba2's and zamba2's 3 (each layout's decode
#: step takes 0.5-1.2 s a rank through CardTransport, six or more ordered
#: collectives a layer, and the script's budget holds 16 for one model)
SERVE_BATCH = (4, 1024)
SERVE_STEPS = {"gemma-2b": 16, "mamba2-1.3b": 3, "zamba2-1.2b": 3}
#: the cache's slots: 1024 + 16, 16 flash-decoding chunks of 65 slots,
#: whole chunks a rank of a sequence split over 2 or 4 model ranks
SERVE_MAX_LEN = 1040
#: 32's classes against the one-device run of the same weights, the
#: largest |logit difference| over the step's largest |logit|: digital,
#: float32 reassociation (a row-parallel read's partial products summed
#: over model; the attention's batched products, the SSD decode's and
#: the head's matmul, which cuBLAS computes otherwise at another count of
#: rows, heads or vocab rows); fakequant, those differences moving DAC and
#: ADC codes (8-bit: one code 1/255 of a read's range) where a value sits
#: on a rounding boundary, the flips carried through 18-48 layers
#: (0.0102-0.0739 measured on the sound layouts, PERF.md section 6).
#: Each decode step is fed the one-device run's greedy token, so a token
#: that flips at a near tie does not change every later step's input.
#: The fakequant class is a bound on gross faults (k or v columns, a
#: cache slot or a tile out of place move the logits by their own
#: scale); a DAC scale not shared over the data ranks reads inside it
#: (PERF.md section 6: the planted fault of 32(b)), and the shared-scale
#: gate catches that one
SERVE_CLASS = {"digital": 1e-4, "fakequant": 1e-1}
#: a row's greedy token may differ from the one-device run's only where
#: that run's two best logits lie within SERVE_TIE times the mode's class
#: of the step's largest |logit|: a fixed band, not the layout's own
#: reading (each flip's gap is recorded)
SERVE_TIE = 1.0


def serve_cfg(get_config, arch, mode):
    """32's config of ``arch``: full size, float32, fakequant at 128-row
    tiles (every row split whole tiles on 1x4 and 2x2)."""
    cfg = get_config(arch).replace(dtype="float32")
    if mode == "fakequant":
        cfg = cfg.replace(analog=True, analog_mode="fakequant",
                          analog_rows=128)
    return cfg


def serve_ref(arch):
    """The one-device run's logits and tokens of ``arch`` (32(a)), for the
    ranks."""
    return ROOT / "build" / f"phase32-ref-{arch}.pt"


def serve_prompts(vocab):
    rng = np.random.default_rng(SERVE_SEED)
    return torch.from_numpy(rng.integers(0, vocab, SERVE_BATCH)).long().cuda()


SERVE_LAUNCHES = ("fakequant", "fakequant_split", "fakequant_tiles")
#: the model and layout 32(b) serves once more in fakequant mode with a
#: planted fault (``shared_scale_probe``): each data rank's DAC scale over
#: its own rows, which the shared-scale gate must catch
SERVE_FAULT = ("gemma-2b", (4, 1))


def serve_run(M, K, cfg, params, tokens, steps, mesh=None, feed=None):
    """A prefill of ``tokens`` into a SERVE_MAX_LEN cache, then ``steps``
    decode steps (``mesh``: under the policy), each fed the greedy token
    of the step before or, with ``feed`` (steps, rows), its row of
    ``feed``; timed with CUDA events: the logits (1 + steps, rows, V) on
    the card, the greedy tokens, the prefill's ms and each step's, the
    fakequant launches and the collectives' bytes of the prefill and of a
    decode step."""
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(2 + steps)]
    moved = collective_bytes()
    with torch.no_grad():
        ev[0].record()
        lg, cache = M.prefill(params, {"tokens": tokens}, cfg,
                              SERVE_MAX_LEN, mesh=mesh)
        ev[1].record()
        torch.cuda.synchronize()
        pre = {k: K.LAUNCHES[k] for k in SERVE_LAUNCHES}
        moved_pre = collective_bytes(moved)
        moved = collective_bytes()
        logits, toks = [lg], []
        for i in range(steps):
            toks.append(lg.argmax(-1))
            t = toks[-1] if feed is None else feed[i]
            lg, cache = M.decode_step(params, cache, t, cfg, mesh=mesh)
            ev[2 + i].record()
            logits.append(lg)
    torch.cuda.synchronize()
    return {"logits": torch.stack(logits), "tokens": torch.stack(toks),
            "cache": cache, "prefill_ms": ev[0].elapsed_time(ev[1]),
            "decode_ms": [ev[1 + i].elapsed_time(ev[2 + i])
                          for i in range(steps)],
            "launches_prefill": pre,
            "launches_decode_step": {
                k: (K.LAUNCHES[k] - pre[k]) / steps
                for k in SERVE_LAUNCHES},
            "collective_bytes_prefill": moved_pre,
            "collective_bytes_decode_step": {
                a: v / steps
                for a, v in collective_bytes(moved).items()}}


def serve_off(got, want):
    """Each step's largest |logit difference| over its largest |logit|,
    of ``got`` against ``want`` (1 + steps, rows, V)."""
    err = (got - want).abs().amax(dim=(1, 2))
    return (err / want.abs().amax(dim=(1, 2))).tolist(), float(err.max())


def phase_serve_one(M, K, get_config, report, gpu_line):
    """32(a), before phase 27's ranks start: each model of SERVE_ARCHS on
    this card alone (the port's 1x1 serving), digital and fakequant: a
    prefill of SERVE_BATCH tokens, SERVE_STEPS greedy decode steps.  Its
    logits and tokens go to build/ for the ranks of 32(b), which hold
    themselves against them; the parameters are freed.  Gates: finite
    logits; no plain version of the fakequant read called; the decode
    attention's chunk sum on the card (``models.layers._chunk_sum``, one
    cumsum) bit-equal to the chunks added one after another, at gemma-2b's
    partials' shapes of 4 and 2 rows."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SERVE_SEED)
    for b in (4, 2):
        t = torch.randn((b, L.DECODE_KV_CHUNKS, 1, 8, 257), generator=gen,
                        device="cuda") * 10.0 ** torch.randint(
            -3, 4, (b, L.DECODE_KV_CHUNKS, 1, 8, 1), generator=gen,
            device="cuda")
        adds = t[:, 0]
        for i in range(1, t.shape[1]):
            adds = adds + t[:, i]
        if not torch.equal(L._chunk_sum(t), adds):
            fail(f"32(a) the chunk sum on the card is not the chunks added "
                 f"in order at {tuple(t.shape)}")
    print(f"32(a) the decode attention's chunk sum (one cumsum) bit-equal to "
          f"the chunks added in order at 4 and 2 rows [{gpu_line}]")
    rows = []
    for arch, _ in SERVE_ARCHS:
        ref = {}
        params = M.init_params(serve_cfg(get_config, arch, "digital"),
                               SERVE_SEED, "cuda")
        for mode in SERVE_MODES:
            cfg = serve_cfg(get_config, arch, mode)
            calls = []
            with plain_counted(K, calls):
                run = serve_run(M, K, cfg, params, serve_prompts(cfg.vocab),
                                SERVE_STEPS[arch])
            if calls or not bool(torch.isfinite(run["logits"]).all()):
                fail(f"32(a) {arch} {mode}: {len(calls)} plain-version "
                     "calls, or logits not finite")
            ref[mode] = {"logits": run["logits"].cpu(),
                         "tokens": run["tokens"].cpu()}
            row = {"arch": arch, "mode": mode, "layers": cfg.n_layers,
                   "prefill_ms": run["prefill_ms"],
                   "decode_ms_per_step": float(np.median(run["decode_ms"])),
                   "launches_prefill": run["launches_prefill"],
                   "launches_decode_step": run["launches_decode_step"],
                   "held_gb": {"params": tree_nbytes(params) / 1e9,
                               "cache": tree_nbytes(run["cache"]) / 1e9}}
            print(f"32(a) {arch} {mode} 1x1: prefill {SERVE_BATCH[0]} x "
                  f"{SERVE_BATCH[1]} in {row['prefill_ms']:.1f} ms, decode "
                  f"{row['decode_ms_per_step']:.2f} ms a step (median of "
                  f"{SERVE_STEPS[arch]}), {run['launches_decode_step']['fakequant']:.0f}"
                  f" fakequant reads a step, held {row['held_gb']} GB "
                  f"[{gpu_line}]")
            report(row)
            rows.append(row)
            del run
        del params
        serve_ref(arch).parent.mkdir(exist_ok=True)
        torch.save(ref, serve_ref(arch))
        del ref
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def seq_split_probe(rec):
    """The sequence-split decode attention (``models.layers.
    _decode_sdpa_split``: q gathered over ``model``, every head's chunk
    partials over the rank's slots, gathered and combined in chunk order;
    plain torch) wrapped for a block: ``rec`` gets its calls, their CUDA
    event ms and the bytes this rank received through their gathers."""
    from repro_torch.models import layers as L
    inner, evs = L._decode_sdpa_split, []

    def probed(*a, **k):
        before = collective_bytes()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        o = inner(*a, **k)
        ev[1].record()
        evs.append(ev)
        rec["bytes"] += sum(collective_bytes(before).values())
        return o
    L._decode_sdpa_split = probed
    try:
        yield rec
    finally:
        L._decode_sdpa_split = inner
        torch.cuda.synchronize()
        rec["calls"] = len(evs)
        rec["ms"] = sum(a.elapsed_time(b) for a, b in evs)


@contextlib.contextmanager
def shared_scale_probe(rec, fault=False):
    """Every max-reduce of a fakequant read's DAC scale over ranks
    (``kernels.ops._all_reduce`` with ``op="max"``, the one
    ``FakequantSplitRead`` makes) wrapped for a block: ``rec`` gets each
    call's axes, this rank's own scale and the reduced one.  ``fault``
    plants a fault first: the reduce skips the data axis (each data
    rank's scale over its own rows)."""
    from repro_torch.kernels import ops as OPS
    inner = OPS._all_reduce

    def planted(t, mesh, axes, op="sum"):
        if op == "max":
            axes = tuple(a for a in axes if a != "data")
        return inner(t, mesh, axes, op)
    base = planted if fault else inner

    def probed(t, mesh, axes, op="sum"):
        out = base(t, mesh, axes, op)
        if op == "max":
            rec.append((tuple(axes), t.detach().reshape(-1).clone(),
                        out.detach().reshape(-1).clone()))
        return out
    OPS._all_reduce = probed
    try:
        yield rec
    finally:
        OPS._all_reduce = inner


def shared_scale_check(rec, mesh):
    """Of ``shared_scale_probe``'s calls: the scales that differ from the
    max over the ranks of the call's axes of each rank's own scale
    (gathered here, apart from the read's reduce), and the calls that
    reduce over the data axis."""
    groups = {}
    for axes, own, got in rec:
        groups.setdefault(axes, []).append((own, got))
    off = 0
    for axes, calls in groups.items():     # in the same order on every rank
        want = torch.cat([o for o, _ in calls])
        for a in axes:
            want = mesh.all_gather(want[None], a, 0).amax(0)
        off += int((want != torch.cat([g for _, g in calls])).sum())
    return off, sum(len(c) for a, c in groups.items() if "data" in a)


def serve_layout(M, K, cfg, params, mesh, ref, mode, steps, fault=False):
    """32(b) on one rank of one layout: this rank's rows served under the
    policy, each decode step fed the one-device run's greedy token, held
    against the one-device run's ``ref``; every shared DAC scale checked
    (``fault``: with the planted fault of ``shared_scale_probe``)."""
    from repro_torch.launch import sharding as S
    rows = local_rows(mesh, SERVE_BATCH[0])
    calls, scales = [], []
    probe = {"bytes": 0}
    with plain_counted(K, calls), seq_split_probe(probe), \
            shared_scale_probe(scales, fault):
        run = serve_run(M, K, cfg, params, serve_prompts(cfg.vocab)[rows],
                        steps, mesh, feed=ref["tokens"][:, rows].cuda())
    scale_off, scale_data = shared_scale_check(scales, mesh)
    want = ref["logits"][:, rows].cuda()
    got = run["logits"]
    off, worst = serve_off(got, want)
    best = want.topk(2, dim=-1).values
    scale = want.abs().amax(dim=(1, 2))[:, None]
    tie = best[..., 0] - best[..., 1] <= SERVE_TIE * SERVE_CLASS[mode] * scale
    same = got.argmax(-1) == want.argmax(-1)
    gaps = ((best[..., 0] - best[..., 1]) / scale)[~same]
    return {"coords": dict(mesh.coords),
            "plan": S.serve_parallel(cfg, mesh).plan(),
            "held": {"params": tree_nbytes(params),
                     "cache": tree_nbytes(run["cache"])},
            "finite": bool(torch.isfinite(got).all()),
            "err_over_scale": off,
            "max_abs_err": worst,
            "bit_equal_steps": sum(bool(torch.equal(a, b))
                                   for a, b in zip(got, want)),
            "tokens_off": int((~same).sum()),
            "near_ties": int(tie.sum()),
            "tokens_off_clear": int((~same & ~tie).sum()),
            "flip_gaps_over_scale": gaps.tolist(),
            "plain_calls": len(calls),
            "shared_scales": len(scales),
            "shared_scales_off": scale_off,
            "shared_scales_over_data": scale_data,
            "seq_split_attention_decode_step": {
                "calls": probe["calls"] / steps,
                "ms": probe["ms"] / steps,
                "bytes": probe["bytes"] / steps},
            **{k: run[k] for k in ("prefill_ms", "decode_ms",
                                   "launches_prefill",
                                   "launches_decode_step",
                                   "collective_bytes_prefill",
                                   "collective_bytes_decode_step")}}


def decode_read_cases(K, S, mesh, cfg):
    """Kernel 4's split and tiles forms at decode rows (SERVE_BATCH[0]
    tokens) on this rank of 1x4: gemma-2b's wqkv by its serving parts
    (k and v by columns) and its w_down by whole row tiles, each against
    its plain version and bit-equal to the whole read, timed beside the
    whole read of the same leaf at the same rows."""
    from repro_torch.core.adc import AdcConfig
    adc = AdcConfig(in_bits=cfg.analog_in_bits, out_bits=cfg.analog_out_bits)
    t, m = SERVE_BATCH[0], mesh.shape["model"]
    n = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.resolved_head_dim
    before = dict(K.LAUNCHES)
    split = split_read_case(K, mesh, cfg, adc, parts=S.fused_parts(
        ("wqkv",), n, cfg, m), t=t)
    tiles = tiles_read_case(K, mesh, cfg, adc, t=t)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    sync = torch.cuda.synchronize
    for case, (k, width) in ((split, (cfg.d_model, n)),
                             (tiles, (cfg.d_ff, cfg.d_model))):
        x = torch.randn((t, k), generator=gen, device="cuda")
        w = torch.randn((k, width), generator=gen, device="cuda") / k ** 0.5
        case["whole_ms"] = cuda_ms(
            lambda i: K.fakequant_read(x, w, adc, cfg.analog_rows), 5, sync)
    K.LAUNCHES.update(before)       # the timing launches not counted
    return {"split": split, "tiles": tiles}


def serve_rank(rank, src):
    """32(b) on one rank: each model of SERVE_ARCHS drawn whole on the
    card one rank at a time and cut into every layout's serving blocks,
    then each layout served in both modes against 32(a)'s run; on
    gemma-2b's 1x4 kernel 4's split and tiles reads at decode rows."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.launch import sharding as S
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    world = dist.get_world_size()
    meshes = {shape: card_mesh(shape)
              for shape in dict.fromkeys(s for _, ls in SERVE_ARCHS
                                         for s in ls)}
    out = {}
    for arch, layouts in SERVE_ARCHS:
        ref = torch.load(serve_ref(arch), weights_only=False)
        base = serve_cfg(get_config, arch, "digital")

        def cut():
            whole = M.init_params(base, SERVE_SEED, "cuda")
            return {shape: S.serve_parallel(base, meshes[shape])
                    .shard_params(whole) for shape in layouts}
        blocks = draw_in_turns(cut, rank, world)
        for shape in layouts:
            for mode in SERVE_MODES:
                out[arch, shape, mode] = serve_layout(
                    M, K, serve_cfg(get_config, arch, mode), blocks[shape],
                    meshes[shape], ref[mode], mode, SERVE_STEPS[arch])
            if (arch, shape) == SERVE_FAULT:
                out["fault"] = serve_layout(
                    M, K, serve_cfg(get_config, arch, "fakequant"),
                    blocks[shape], meshes[shape], ref["fakequant"],
                    "fakequant", SERVE_STEPS[arch], fault=True)
            del blocks[shape]
            torch.cuda.empty_cache()
        del ref
    out["reads"] = decode_read_cases(K, S, meshes[(1, 4)], serve_cfg(
        get_config, "gemma-2b", "fakequant"))
    out["seconds"] = time.perf_counter() - t0
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def serve_expected(cfg, shape):
    """The fakequant reads of one decode step on a rank of ``shape``:
    (all, column splits, row splits)."""
    n = cfg.n_layers
    if cfg.family == "ssm":
        reads, col = 2 * n, n
    elif cfg.family == "hybrid":
        g = n // cfg.attn_every
        reads, col = 2 * n + 5 * g, n + 2 * g
    else:
        reads, col = 4 * n, 2 * n
    return (reads, col, col) if shape[1] > 1 else (reads, 0, 0)


def serve_seq_calls(cfg, shape):
    """The sequence-split decode attentions of one decode step on a rank
    of ``shape``: one a layer where the dense family's kv heads do not
    divide over ``model``."""
    m = shape[1]
    return cfg.n_layers if cfg.family == "dense" and m > 1 \
        and cfg.n_kv_heads % m else 0


def phase_serve_parallel(DR, TM, get_config, one, report, gpu_line):
    """32(b): each model of SERVE_ARCHS served under the sharding policy
    on its layouts, each rank its own process on this card (phase 27(a)'s
    ranks, ``then=``), against 32(a)'s one-device run of the same
    weights.  Gates, each rank: its held parameter and cache bytes equal
    ``launch.dryrun.serving_state``'s for its coordinates, and for
    gemma-2b the policy's exactly (the SSM family's beyond it only
    ``in_proj``'s and the conv state's whole B / C / dt parts, as the
    dry run names them); finite logits of the prefill and every decode
    step (each fed the one-device run's token) within SERVE_CLASS of the
    one-device run's; the same greedy tokens but at a near tie
    (SERVE_TIE); on gemma-2b's 1x4 and 2x2 the sequence-split decode
    attention once a layer a step; in fakequant mode no plain-version
    call, each decode step's
    fakequant reads the one-device step's, on model ranks its column
    splits on kernel 4's split form and its row splits on the tiles
    form (``serve_expected``); kernel 4's split and tiles reads at
    decode rows against their plain versions and bit-equal to the whole
    read."""
    from repro_torch.configs.base import ShapeSpec
    ranks = spawn_layout(4, "serve32")
    cell = ShapeSpec("serve32", "decode", SERVE_MAX_LEN, SERVE_BATCH[0])
    by_one = {(r["arch"], r["mode"]): r for r in one}
    rows, dry_of = [], {}
    for arch, layouts in SERVE_ARCHS:
        for shape in layouts:
            label = "x".join(map(str, shape))
            for mode in SERVE_MODES:
                cfg = serve_cfg(get_config, arch, mode)
                base = by_one[arch, mode]
                per = [r[arch, shape, mode] for r in ranks]
                want = serve_expected(cfg, shape)
                for i, r in enumerate(per):
                    at = (r["coords"]["data"], r["coords"]["model"])
                    if (arch, shape, at) not in dry_of:  # either mode's
                        dry_of[arch, shape, at] = DR.serving_state(
                            cfg, cell, DR.DryMesh(shape, ("data", "model"),
                                                  coords=at))[3]
                    dry = dry_of[arch, shape, at]
                    what = f"32(b) {arch} {mode} {label} rank {i}"
                    if r["held"] != dry["held"]:
                        fail(f"{what}: holds {r['held']}, the dry run "
                             f"{dry['held']}")
                    extra = {k: r["held"][k] - dry["policy"][k]
                             for k in r["held"]}
                    parts = set(dry["excess"])
                    if sum(extra.values()) != sum(dry["excess"].values()) \
                            or (cfg.family == "dense" and parts) \
                            or not parts <= {"params/layers/ssm/in_proj/w",
                                             "cache/0/conv"}:
                        fail(f"{what}: {extra} bytes beyond the policy, the "
                             f"dry run's named parts {dry['excess']}")
                    worst = max(r["err_over_scale"])
                    if not r["finite"] or worst > SERVE_CLASS[mode] \
                            or r["tokens_off_clear"]:
                        fail(f"{what}: finite {r['finite']}, logits off the "
                             f"1x1 run's by {worst:.3g} of their scale "
                             f"(class {SERVE_CLASS[mode]}), greedy tokens "
                             f"off {r['tokens_off']} ({r['tokens_off_clear']}"
                             f" beyond a near tie; the 1x1's top-two gaps of "
                             f"the flips over the scale "
                             f"{r['flip_gaps_over_scale']})")
                    if mode == "fakequant" and (r["shared_scales_off"] or (
                            shape[0] > 1 and r["shared_scales_over_data"]
                            != r["launches_prefill"]["fakequant"]
                            + SERVE_STEPS[arch] * r["launches_decode_step"][
                                "fakequant"])):
                        fail(f"{what}: {r['shared_scales_off']} of "
                             f"{r['shared_scales']} shared DAC scales not the "
                             "max over their ranks' own, "
                             f"{r['shared_scales_over_data']} shared over "
                             "the data ranks")
                    seq = r["seq_split_attention_decode_step"]["calls"]
                    if seq != serve_seq_calls(cfg, shape):
                        fail(f"{what}: {seq} sequence-split decode "
                             f"attentions a step, expected "
                             f"{serve_seq_calls(cfg, shape)}")
                    if mode != "fakequant":
                        continue
                    got = r["launches_decode_step"]
                    split = (got["fakequant_split"] - got["fakequant_tiles"],
                             got["fakequant_tiles"])
                    if r["plain_calls"] or (got["fakequant"], *split) != want \
                            or got["fakequant"] != \
                            base["launches_decode_step"]["fakequant"]:
                        fail(f"{what}: {r['plain_calls']} plain calls, reads "
                             f"a decode step {got} (all, split, tiles "
                             f"expected {want}; 1x1 "
                             f"{base['launches_decode_step']})")
                row = {"arch": arch, "mode": mode, "layout": label,
                       "layers": cfg.n_layers, "plan": per[0]["plan"],
                       "held_gb_per_rank": [
                           {k: v / 1e9 for k, v in r["held"].items()}
                           for r in per],
                       "prefill_ms_per_rank": [r["prefill_ms"] for r in per],
                       "decode_ms_per_rank": [float(np.median(r["decode_ms"]))
                                              for r in per],
                       "prefill_ms_1x1": base["prefill_ms"],
                       "decode_ms_1x1": base["decode_ms_per_step"],
                       "err_over_scale": max(max(r["err_over_scale"])
                                             for r in per),
                       "err_over_scale_per_step": np.max(
                           [r["err_over_scale"] for r in per], 0).tolist(),
                       "max_abs_err": max(r["max_abs_err"] for r in per),
                       "tokens_off": [r["tokens_off"] for r in per],
                       "near_ties": [r["near_ties"] for r in per],
                       "flip_gaps_over_scale": [r["flip_gaps_over_scale"]
                                                for r in per],
                       "bit_equal_steps_per_rank": [r["bit_equal_steps"]
                                                    for r in per],
                       "launches_decode_step": per[0]["launches_decode_step"],
                       "shared_scales_per_rank": [r["shared_scales"]
                                                  for r in per],
                       "launches_prefill": per[0]["launches_prefill"],
                       "collective_bytes_decode_step":
                           per[0]["collective_bytes_decode_step"],
                       "collective_bytes_prefill":
                           per[0]["collective_bytes_prefill"],
                       "seq_split_attention_decode_step": [
                           r["seq_split_attention_decode_step"]
                           for r in per]}
                print(f"32(b) {arch} {mode} {label}: prefill ms per rank "
                      f"{[round(v, 1) for v in row['prefill_ms_per_rank']]}"
                      f" (1x1 {base['prefill_ms']:.1f}), decode ms a step "
                      f"per rank {[round(v, 2) for v in row['decode_ms_per_rank']]}"
                      f" (1x1 {base['decode_ms_per_step']:.2f}), held GB "
                      f"per rank {[round(sum(h.values()), 3) for h in row['held_gb_per_rank']]}"
                      f", logits within {row['err_over_scale']:.3g} of the "
                      f"1x1's scale, greedy tokens off a rank "
                      f"{row['tokens_off']} (near ties {row['near_ties']}; "
                      f"the flips' 1x1 gaps over the scale "
                      f"{row['flip_gaps_over_scale']}), "
                      f"bit-equal steps "
                      f"{row['bit_equal_steps_per_rank']} of "
                      f"{1 + SERVE_STEPS[arch]}, reads a decode step "
                      f"{row['launches_decode_step']}, collective bytes a "
                      f"decode step {row['collective_bytes_decode_step']} "
                      f"[{gpu_line}]")
                seq = row["seq_split_attention_decode_step"]
                if seq[0]["calls"]:
                    print(f"32(b) {arch} {mode} {label}: the sequence-split "
                          f"decode attention, {seq[0]['calls']:.0f} a step, "
                          f"ms a step per rank "
                          f"{[round(q['ms'], 2) for q in seq]}, bytes "
                          f"received a step per rank "
                          f"{[q['bytes'] for q in seq]} [{gpu_line}]")
                report(row)
                rows.append(row)
    fault = [r["fault"] for r in ranks]
    caught = sum(f["shared_scales_off"] for f in fault)
    if not caught:
        fail("32(b) the planted fault (each data rank's DAC scale over its "
             "own rows) was not caught by the shared-scale gate")
    worst = max(max(f["err_over_scale"]) for f in fault)
    label = "x".join(map(str, SERVE_FAULT[1]))
    print(f"32(b) planted fault, {SERVE_FAULT[0]} fakequant {label} with each "
          f"data rank's DAC scale over its own rows: {caught} of "
          f"{sum(f['shared_scales'] for f in fault)} shared scales off the "
          f"ranks' max (caught); logits within {worst:.3g} of the 1x1's scale "
          f"(class {SERVE_CLASS['fakequant']}), per step "
          f"{[round(v, 4) for v in np.max([f['err_over_scale'] for f in fault], 0)]}"
          f", greedy tokens off a rank {[f['tokens_off'] for f in fault]} "
          f"(near ties {[f['near_ties'] for f in fault]}) [{gpu_line}]")
    report({"fault": {"arch": SERVE_FAULT[0], "layout": label,
                      "shared_scales_off": caught,
                      "err_over_scale": worst,
                      "err_over_scale_per_step": np.max(
                          [f["err_over_scale"] for f in fault], 0).tolist(),
                      "tokens_off": [f["tokens_off"] for f in fault],
                      "near_ties": [f["near_ties"] for f in fault]}})
    reads = ranks[0]["reads"]
    for i, r in enumerate(ranks):
        for case in ("split", "tiles"):
            c = r["reads"][case]
            if not c["ok"] or not c["bit_equal_whole_read"]:
                fail(f"32(b) rank {i}: kernel 4's {case} form at decode rows "
                     f"is off its plain version or the whole read: {c}")
    print(f"32(b) kernel 4 at {SERVE_BATCH[0]} decode rows on rank 0 of "
          f"1x4 (gemma-2b): split form {1e3 * reads['split']['ms']:.1f} us "
          f"(plain {1e3 * reads['split']['plain_ms']:.1f}, the whole wqkv "
          f"read {1e3 * reads['split']['whole_ms']:.1f}), tiles form "
          f"{1e3 * reads['tiles']['ms']:.1f} us (plain "
          f"{1e3 * reads['tiles']['plain_ms']:.1f}, the whole w_down read "
          f"{1e3 * reads['tiles']['whole_ms']:.1f}); the ranks' job took "
          f"{max(r['seconds'] for r in ranks):.1f} s, peak "
          f"{max(r['peak_gb'] for r in ranks):.2f} GB a rank [{gpu_line}]")
    report({"reads": reads, "seconds": [r["seconds"] for r in ranks],
            "peak_gb": [r["peak_gb"] for r in ranks]})
    return rows, reads


def serve_entry(rows, reads, case):
    """The kernels-line figures of 32(b) for kernel 4's split (``case``
    ``split``) or tiles form: its reads a decode step a rank by model,
    mode and layout, and its read at decode rows."""
    c = reads[case]
    key = "fakequant_tiles"
    return {"launches_decode_step_serve_32": {
        f"{r['arch']} {r['layout']}": (
            r["launches_decode_step"][key] if case == "tiles" else
            r["launches_decode_step"]["fakequant_split"]
            - r["launches_decode_step"][key])
        for r in rows if r["mode"] == "fakequant"},
        "decode_rows_32": {k: c[k] for k in (
            "T", "max_abs_err", "ms", "plain_ms", "whole_ms", "bound_ms",
            "bound_by")}}


TP_JOBS = {"qat": tp_rank_qat, "gemma": tp_rank_gemma,
           "inexact": tp_rank_inexact, "moe": moe_rank_qat,
           "scout1x4": lambda rank, src: scout_rank(rank, src, (1, 4)),
           "scout1x2": lambda rank, src: scout_rank(rank, src, (1, 2)),
           "family": family_rank, "vlm1x4": vlm_tp_rank, "seq30": seq_rank,
           "serve32": serve_rank}


class CardTransport:
    """The collectives of the ranks of a layout that share this one card
    (each rank its own process in a gloo group: NCCL takes one card a
    rank), as a ``launch.mesh.Mesh`` exchange hook: each rank owns a slot
    of ``slot_bytes`` on the card that every other rank maps through CUDA
    IPC.  A collective moves its operand through the slots in pieces:
    each rank copies its piece into its slot, the group meets at a gloo
    barrier, each rank reads the slots it needs (gathers in rank order,
    sums and maxima over the ranks in rank order) and the group meets
    again before the slots are reused.  Bits move on the card; gloo
    carries only the barriers (staging the card's tensors through gloo
    took 78 s a gemma-2b step, this 5.6 s)."""

    def __init__(self, slot_bytes=1 << 27):
        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor
        import warnings
        dev = torch.device("cuda", torch.cuda.current_device())
        # IPC shares whole allocations: the slot takes a plain segment
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:False")
            try:
                self.slot = torch.empty(slot_bytes, dtype=torch.uint8,
                                        device=dev)
            finally:
                if "expandable_segments:True" in os.environ.get(
                        "PYTORCH_CUDA_ALLOC_CONF", ""):
                    torch.cuda.memory._set_allocator_settings(
                        "expandable_segments:True")
        handles = [None] * dist.get_world_size()
        dist.all_gather_object(handles, reduce_tensor(self.slot))
        me = dist.get_rank()
        self.slots = [self.slot if r == me else fn(*args)
                      for r, (fn, args) in enumerate(handles)]
        self.bytes = slot_bytes

    @staticmethod
    def _group(mesh, axis):
        from repro_torch.core.shardctx import flat_index
        return [flat_index(mesh.shape, {**mesh.coords, axis: i},
                           mesh.axis_names)
                for i in range(mesh.shape[axis])], mesh.group(axis)

    def _meet(self, group):
        import torch.distributed as dist
        torch.cuda.current_stream().synchronize()
        dist.barrier(group=group)

    def exchange(self, mesh, t, axis):
        """``t`` of every rank of the axis group, in rank order."""
        ranks, group = self._group(mesh, axis)
        src = t.contiguous().reshape(-1).view(torch.uint8)
        outs = [torch.empty_like(src) for _ in ranks]
        for off in range(0, max(src.numel(), 1), self.bytes):
            n = min(self.bytes, src.numel() - off)
            self.slot[:n].copy_(src[off:off + n])
            self._meet(group)
            for o, r in zip(outs, ranks):
                o[off:off + n].copy_(self.slots[r][:n])
            self._meet(group)
        return [o.view(t.dtype).view(t.shape) for o in outs]

    def _combine(self, t, ranks, group, op, dest=None):
        """The sum (or max) over ``ranks`` of their ``t``, in rank order;
        with ``dest`` (a global rank) only that rank forms it."""
        import torch.distributed as dist
        src = t.contiguous().reshape(-1)
        out = torch.empty_like(src) if dest in (None, dist.get_rank()) \
            else None
        esize = src.element_size()
        per = self.bytes // esize
        for off in range(0, max(src.numel(), 1), per):
            n = min(per, src.numel() - off)
            self.slot[:n * esize].view(src.dtype).copy_(src[off:off + n])
            self._meet(group)
            if out is not None:
                acc = None
                for r in ranks:
                    v = self.slots[r][:n * esize].view(src.dtype)
                    acc = v.clone() if acc is None else (
                        acc + v if op == "sum" else torch.maximum(acc, v))
                out[off:off + n].copy_(acc)
            self._meet(group)
        return None if out is None else out.view(t.shape)

    def reduce(self, mesh, t, axis, op):
        ranks, group = self._group(mesh, axis)
        return self._combine(t, ranks, group, op)

    def reduce_scatter(self, mesh, t, axis, dim):
        ranks, group = self._group(mesh, axis)
        src = t.movedim(dim, 0)
        loc = src.shape[0] // len(ranks)
        mine = None
        for j, r in enumerate(ranks):     # each rank's chunk in turn
            got = self._combine(src[j * loc:(j + 1) * loc], ranks, group,
                                "sum", dest=r)
            mine = got if got is not None else mine
        return mine.movedim(0, dim)


_TRANSPORT = {}


def card_mesh(shape):
    """A (data, model) mesh of this job's ranks (a gloo group), its
    collectives carried by this process's :class:`CardTransport` (made on
    first use: every rank of the job takes part)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    if "card" not in _TRANSPORT:
        _TRANSPORT["card"] = CardTransport()
    mesh.layout = _TRANSPORT["card"]
    return mesh


def tp_rank(rank, world, rdv, jobs, out, src):
    """One rank of a layout on this card: its own process, a gloo group
    whose collectives go through :class:`CardTransport`, each of
    ``TP_JOBS[job]`` for ``jobs`` in turn, their results saved for the
    parent."""
    sys.path.insert(0, src)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    init_distributed("cpu", f"file://{rdv}", rank, world)
    res = {job: TP_JOBS[job](rank, src) for job in jobs}
    torch.save(res, f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


#: The results of jobs that ran in the processes of an earlier job
#: (:func:`spawn_layout`), by (world, job), until their phase asks.
_RAN = {}


def spawn_layout(world, job, then=()):
    """``world`` ranks of ``job`` on this card (``torch.multiprocessing``,
    a file rendezvous under build/); their results in rank order.  Every
    process is joined (mp.spawn ends the others when one fails).  The
    jobs ``then`` run after ``job`` in the same processes (each process's
    start and its card's setup, 10-25 s, paid once), their results kept
    for their own phase's ``spawn_layout(world, job)``, which returns
    them without spawning."""
    import gc
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    if (world, job) in _RAN:
        return _RAN.pop((world, job))
    jobs = (job, *then)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"{' + '.join(jobs)}: {world} ranks; this process holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card "
          f"({torch.cuda.memory_reserved() / 1e9:.2f} reserved)", flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tp27-", dir=ROOT / "build"))
    # the ranks share one card: segments that grow in place keep each
    # rank's allocator from holding freed blocks it cannot reuse
    prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        mp.spawn(tp_rank, args=(world, str(tmp / "rdv"), jobs,
                                str(tmp / "res"), str(ROOT / "src")),
                 nprocs=world, join=True)
        ranks = [torch.load(f"{tmp / 'res'}.{r}", weights_only=False,
                            map_location="cpu") for r in range(world)]
        for later in then:
            _RAN[world, later] = [r[later] for r in ranks]
        return [r[job] for r in ranks]
    finally:
        if prev is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
        shutil.rmtree(tmp, ignore_errors=True)


def params_class(got, want, lr):
    """Satellite 1's parameter class: within 1e-5 relative plus 1e-6,
    except elements whose gradient lies within float32 rounding of 0
    (adamw moves them by up to 2 lr): (elements off, elements, worst
    move off)."""
    off = total = 0
    worst = 0.0
    by_leaf = {}
    for path, w in leaves_of(want):
        g = tree_get(got, path)
        d = np.abs(g - w)
        bad = d > 1e-5 * np.abs(w) + 1e-6
        off += int(bad.sum())
        total += w.size
        if bad.any():
            worst = max(worst, float(d[bad].max()))
            by_leaf["/".join(path)] = (int(bad.sum()), int(w.size))
    return off, total, worst, by_leaf


def phase_tp_qat(K, TL, TO, get_config, report, gpu_line, then=()):
    """27(a): lm100m at full width cut to TP_QAT_LAYERS layers, QAT at
    128-row tiles, 8 x 256 tokens:
    one FSDP + TP step on the 2x2, 1x4 and 4x1 layouts (each rank its own process on this
    card) against the 1x1 step on the card from the same state.  Gates:
    the loss within 1e-4 relative; on ``model`` ranks every rank's
    split-range read (a column split) and tiles read (a row split)
    against its plain version (fq_agrees' class, the range combined
    across ranks) and bit-equal to the whole read, and the step launching
    both; each rank's fakequant reads in its step equal to the 1x1
    step's; the parameters after the step, unsharded, in satellite 1's
    class (off under 1e-3 of the elements, by at most 2 lr).  The jobs
    ``then`` run in the ranks' processes after 27(a)'s
    (:func:`spawn_layout`)."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.adc import AdcConfig
    cfg = tp_qat_cfg(get_config)
    cases = split_kernel_cases(K, AdcConfig(in_bits=cfg.analog_in_bits,
                                            out_bits=cfg.analog_out_bits),
                               cfg.analog_rows, report)
    opt = TO.adamw(TP_LR)
    state = TL.init_state(TP_SEED, cfg, opt, "cuda")
    step = TL.make_train_step(cfg, opt)
    batch = tp_tokens(cfg.vocab, *TP_BATCH)
    step(state, batch)          # warm-up (the step leaves its input state)
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    state, mets, ms1 = timed_step(step, state, batch)
    one = {"loss": float(mets["loss"]), "ms": ms1,
           "grad_norm": float(mets["grad_norm"]),
           "reads": K.LAUNCHES["fakequant"],
           "params": params_to_numpy(state["params"])}
    del state
    ranks = spawn_layout(4, "qat", then)
    rows = []
    for shape in TP_LAYOUTS:
        label = "x".join(map(str, shape))
        per = [r[shape] for r in ranks]
        for i, r in enumerate(per):
            if abs(r["loss"] - one["loss"]) > 1e-4 * abs(one["loss"]):
                fail(f"27(a) {label} rank {i}: loss {r['loss']} against the "
                     f"1x1 step's {one['loss']}")
            if r["launches"]["fakequant"] != one["reads"]:
                fail(f"27(a) {label} rank {i}: {r['launches']['fakequant']} "
                     f"fakequant reads in its step, the 1x1 step "
                     f"{one['reads']}")
            if shape[1] == 1:
                continue
            for case in ("split", "tiles"):
                if not r[case]["ok"] or \
                        not r[case]["bit_equal_whole_read"]:
                    fail(f"27(a) {label} rank {i}: the {case} read is off "
                         f"its plain version or the whole read: "
                         f"{r[case]}")
            if not r["launches"]["fakequant_split"] \
                    or not r["launches"]["fakequant_tiles"]:
                fail(f"27(a) {label} rank {i}: no split-range or tiles "
                     f"read in the step ({r['launches']})")
        off, total, worst, by_leaf = params_class(per[0]["params"],
                                                  one["params"], TP_LR)
        if off > 1e-3 * total or worst > 2 * TP_LR * 1.01:
            fail(f"27(a) {label}: {off} of {total} parameters off the 1x1 "
                 f"step's class (worst {worst:.3g}; by leaf {by_leaf}; grad "
                 f"norm {per[0]['grad_norm']} against {one['grad_norm']})")
        tp = shape[1] > 1
        row = {"layout": label, "loss": per[0]["loss"],
               "losses_per_rank": [r["loss"] for r in per],
               "loss_1x1": one["loss"], "grad_norm": per[0]["grad_norm"],
               "grad_norm_1x1": one["grad_norm"],
               "ms_per_rank": [r["ms"] for r in per],
               "ms_1x1": one["ms"], "reads_per_rank": one["reads"],
               "split_reads_per_rank": [r["launches"]["fakequant_split"]
                                        for r in per],
               "tiles_reads_per_rank": [r["launches"]["fakequant_tiles"]
                                        for r in per],
               "params_off": off, "params": total, "plan": per[0]["plan"],
               "split": [r["split"] for r in per] if tp else [],
               "tiles": [r["tiles"] for r in per] if tp else [],
               "kernel_cases": cases}
        reads = (f"split read max err "
                 f"{max(s['max_abs_err'] for s in row['split']):.3g}, "
                 f"{per[0]['split']['ms']:.3f} ms (plain "
                 f"{per[0]['split']['plain_ms']:.3f}); tiles read max err "
                 f"{max(s['max_abs_err'] for s in row['tiles']):.3g}, "
                 f"{per[0]['tiles']['ms']:.3f} ms (plain "
                 f"{per[0]['tiles']['plain_ms']:.3f})") if tp else \
            "no model split"
        print(f"27(a) {label}: loss {row['loss']!r} (1x1 "
              f"{one['loss']!r}), grad norm {row['grad_norm']!r} (1x1 "
              f"{one['grad_norm']!r}), step ms per rank "
              f"{[round(v, 1) for v in row['ms_per_rank']]} (1x1 "
              f"{one['ms']:.1f}; warm steps; each rank its own process on "
              f"this card), {one['reads']} fakequant reads a rank "
              f"({row['split_reads_per_rank'][0]} split-range, "
              f"{row['tiles_reads_per_rank'][0]} tiles), "
              f"{off} of {total} parameters off; {reads} [{gpu_line}]")
        report(row)
        rows.append(row)
    return rows


def phase_tp_gemma(M, TL, TO, DR, S, TM, get_config, report, gpu_line):
    """27(b): gemma-2b at full width cut to GEMMA_TP_LAYERS of its 18
    layers (vocab 256000), digital
    bfloat16, FSDP on 4x1 (each rank its own process on this card) after
    the 1x1 forward's loss from the same parameters (freed first; the
    1x1 step's adamw update does not fit one card), over 4 x 1024
    tokens.  Gates: each rank's held params, m and v bytes equal
    launch.dryrun's policy bytes for its coordinates, exactly; a finite
    loss within 1e-2 relative of the 1x1 step's; two layer gathers a
    layer a rank (the forward and the rematted backward)."""
    from repro_torch.configs.base import ShapeSpec
    cfg = gemma_tp_cfg(get_config)
    # the 1x1 step's loss (the step reports it before its update): its
    # whole adamw state and update (about 70 GB at this size: the tree-wide
    # m / v rebuild, PERF.md section 6) do not fit beside the activations
    params = M.init_params(cfg, TP_SEED, "cuda")
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.no_grad():
        ev[0].record()
        loss, _ = M.loss_fn(params, tp_tokens(cfg.vocab, *GEMMA_BATCH), cfg)
        ev[1].record()
    torch.cuda.synchronize()
    one = {"loss": float(loss), "ms": ev[0].elapsed_time(ev[1]),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, loss
    ranks = spawn_layout(4, "gemma")
    like = M.init_params(cfg, None, "meta")
    shape = ShapeSpec("train_tp27", "train", GEMMA_BATCH[1], GEMMA_BATCH[0])
    rec = DR.reckon(cfg, shape, DR.make_mesh("4x1"))
    for i, r in enumerate(ranks):
        mesh = TM.Mesh((4, 1), ("data", "model"),
                       coords=(r["coords"]["data"], r["coords"]["model"]))
        specs = S.params_shardings(like, cfg, mesh)
        policy = DR.block_bytes(like, specs, mesh)
        held = r["held"]
        if held["params"] != policy or held["m"] != policy \
                or held["v"] != policy:
            fail(f"27(b) rank {i}: holds {held}, the policy "
                 f"{policy} bytes a tree")
        arg = sum(held.values()) + DR.tree_bytes(M.input_specs(
            cfg, shape, batch=GEMMA_BATCH[0] // 4))
        if arg / 1e9 != rec["mem"]["policy_argument_gb"]:
            fail(f"27(b) rank {i}: {arg} argument bytes, the dry run "
                 f"{rec['mem']['policy_argument_gb']} GB")
        if not math.isfinite(r["loss"]) \
                or abs(r["loss"] - one["loss"]) > 1e-2 * abs(one["loss"]):
            fail(f"27(b) rank {i}: loss {r['loss']}, the 1x1 step's "
                 f"{one['loss']}")
        if r["layer_gathers"] != 2 * cfg.n_layers:
            fail(f"27(b) rank {i}: {r['layer_gathers']} layer gathers, "
                 f"expected {2 * cfg.n_layers}")
    row = {"tokens": f"{GEMMA_BATCH[0]} x {GEMMA_BATCH[1]}",
           "loss": ranks[0]["loss"], "loss_1x1": one["loss"],
           "ms_per_rank": [r["ms"] for r in ranks], "ms_1x1": one["ms"],
           "held_bytes_per_rank": ranks[0]["held"],
           "dryrun_policy_argument_gb": rec["mem"]["policy_argument_gb"],
           "dryrun_replicated_by_port_gb": rec["mem"]["replicated_by_port_gb"],
           "peak_gb_per_rank": [r["peak_gb"] for r in ranks],
           "peak_gb_1x1": one["peak_gb"],
           "layer_gathers": ranks[0]["layer_gathers"]}
    print(f"27(b) gemma-2b 4x1 FSDP over {row['tokens']} tokens: loss "
          f"{row['loss']:.5f} (1x1 {one['loss']:.5f}), step ms per rank "
          f"{[round(v, 1) for v in row['ms_per_rank']]} (1x1 forward "
          f"{one['ms']:.1f}), held {sum(ranks[0]['held'].values()) / 1e9:.3f}"
          f" GB a rank (= the dry run's policy), peak "
          f"{max(row['peak_gb_per_rank']):.2f} GB a rank (1x1 "
          f"{one['peak_gb']:.2f}), {row['layer_gathers']} layer gathers "
          f"[{gpu_line}]")
    report(row)
    return row


def inexact_read_case(K, S, TM, path, x, g, ref, ws, cfg, mcfg, transpose):
    """27(c)'s reads for one container and direction: every rank of 2x4
    (emulated one after another: ``launch.mesh.emulate_layout``) reads
    with ``exact=False`` (its own tiles summed, the ranks' sums
    all-reduced, rescaled once); each within ``(tiles - 1) * 2^-23 * sum
    |partial| * |x_scale / w_scale| + 2^-23 |exact|`` an element of the
    exact read (two float sums of the same terms in two orders, and the
    rescale).  Each
    rank's kernel work timed in both forms: its partials-form read with
    the tile sum of its own tiles (exact=False) or of every rank's
    gathered tiles (exact)."""
    import dataclasses
    axes = ("data", "model")
    shape = tuple(g.shape)
    whole = K.xbar_fused_read(x, g, ref, ws, cfg, transpose=transpose)
    lyr = shape[0]
    xf = x.float().contiguous()
    sc = K.read_scales(xf, ws.reshape(lyr), cfg.adc.in_levels)
    part = K._read_cuda(xf, g, ref, sc, cfg, transpose, partials=True)
    blocks = {}
    for coords in TM.layout_coords(TM.emulated_mesh(INEXACT_LAYOUT, axes)):
        m = TM.emulated_mesh(INEXACT_LAYOUT, axes, coords)
        spec = S.analog_update_specs(path, shape, mcfg, m)["g"]
        sl = S.block_slices(shape, spec, m)
        meta = dataclasses.replace(S.shard_meta(shape, spec, m), exact=False)
        blocks[m.rank] = (g[sl].contiguous(), ref[sl].contiguous(),
                          ws[sl[:-2]].contiguous(), meta, sl)
    meta = blocks[0][3]
    red = meta.col if transpose else meta.row
    n_red = math.prod(TM.emulated_mesh(INEXACT_LAYOUT, axes).shape[a]
                      for a in red)
    # two float sums of the same tR terms in two orders: each within (tR -
    # 1) u sum|p| of the exact sum (u = 2^-24), and the rescale's rounding
    bound = (part.shape[1] - 1) * 2.0 ** -23 * part.abs().sum(1) \
        * sc[:, 1, None, None].abs() + 2.0 ** -23 * whole.abs()

    def rank_read(m):
        gb, rb, wb, mt, _ = blocks[m.rank]
        return K.manual_collective_read(x, gb, rb, wb, cfg, mt,
                                        transpose=transpose, mesh=m)
    ys = TM.emulate_layout(INEXACT_LAYOUT, axes, rank_read)
    worst = max(((y - whole).abs() / bound.clamp_min(1e-30)).max().item()
                for y in ys)
    ok = all(bool(((y - whole).abs() <= bound).all()) for y in ys)
    sync = torch.cuda.synchronize
    loose_ms = exact_ms = 0.0
    for r, (gb, rb, wb, mt, sl) in blocks.items():
        off = sl[-1 if transpose else -2].start or 0
        width = gb.shape[-1 if transpose else -2]
        xr = xf.narrow(2, off, width).contiguous()
        scr = sc  # the whole drive's scales (the layer dim is never split)
        pr = K._read_cuda(xr, gb, rb, scr, cfg, transpose, partials=True)
        loose_ms += cuda_ms(lambda i: K._reduce_tiles_cuda(
            K._read_cuda(xr, gb, rb, scr, cfg, transpose, partials=True),
            scr, transpose), 3, sync)
        exact_ms += cuda_ms(lambda i: K._reduce_tiles_cuda(
            torch.cat([K._read_cuda(xr, gb, rb, scr, cfg, transpose,
                                    partials=True)] + [pr] * (n_red - 1),
                      dim=1), scr, transpose), 3, sync)
        del pr
    whole_ms = cuda_ms(lambda i: K.xbar_fused_read(
        x, g, ref, ws, cfg, transpose=transpose), 3, sync)
    return {"case": path[-1], "B": x.shape[-2], "transpose": transpose,
            "within_bound": ok, "worst_err_over_bound": worst,
            "whole_ms": whole_ms, "exact_form_ms": exact_ms,
            "inexact_form_ms": loose_ms}


def write_distance(after, before, base):
    """Each container's write ``after - base`` against ``before - base``,
    in 2-norm relative to the latter."""
    return {k: float((after[k] - before[k]).norm()
                     / (before[k] - base[k]).norm()) for k in before}


def first_read_bound(K, cfg, xcfg, c, x):
    """The reassociation bound of layer 0's forward read of container
    ``c`` at drive ``x`` (B, K), against the exact read's partials: an
    element of two float sums of the same tiles' partials in two orders
    lies within ``(tiles - 1) * 2^-23 * sum |partial|`` of the other
    (``u = 2^-24`` each), times the rescale, plus the rescale's own
    rounding of the exact output ``exact``."""
    g, ref = c["g"][:1], c["ref"][:1]
    ws = torch.as_tensor(c["w_scale"], device="cuda").float() \
        .reshape(-1)[:1].contiguous()
    xf = x.reshape(1, -1, x.shape[-1]).float().cuda().contiguous()
    sc = K.read_scales(xf, ws, xcfg.adc.in_levels)
    part = K._read_cuda(xf, g, ref, sc, xcfg, False, partials=True)
    return (part.shape[1] - 1) * 2.0 ** -23 * part.abs().sum(1) \
        * sc[:, 1, None, None].abs()


def phase_tp_inexact(K, S, TM, TA, syn, get_config, report, gpu_line):
    """27(c): ``AnalogTrainStep(exact=False)`` on 2x4, lm100m in device
    mode at full width with phase 7's settings.  (i) Every shard-local
    read of the four containers (12 layers), both directions, at B = 4
    and B = 2048, within the reassociation bound of the exact read;
    (ii) one step exact, one exact=False and one exact=False with a
    planted fault (rank ``FAULT_RANK``'s own tile sum dropped in the
    step's first read) from the same state, batch and write seed (each
    rank its own process on this card): the exact step bit-equal to the
    one-device step; the writes' launches unchanged; the step's first
    read (layer 0's wqkv, the same drive in every form) within the
    reassociation bound in the exact=False step, and off it in the
    faulty one (the gate sees a fault of one rank in one read); the
    loss and each container's write (new g - initial g) against the
    exact step's: the write within ``WRITE_LIMIT`` times, in 2-norm, the
    largest distance that a one-ulp nudge of the embedding (every
    element, or a random half) puts between two one-device steps, and
    the faulty step's beyond it in some container (the gate sees the
    fault); the loss within 1e-3 relative.  The device-mode step is chaotic at this
    size: an ulp anywhere flips DAC and ADC codes downstream, and a
    rank-2048 write sums them into nearly every cell, so the cells off
    (beyond 1e-4 of their own write) and not bit-equal are printed, not
    bounded, and the nudges' and the fault's distances are printed
    beside the exact=False step's."""
    cfg = tp_inexact_cfg(get_config)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = TA.init_state(gen, cfg, device="cuda")
    from repro_torch.core.tiled_analog import crossbar_from_model
    xcfg = crossbar_from_model(cfg)
    reads = []
    for name in ("wqkv", "wo", "w_upgate", "w_down"):
        sub = "attn" if name in ("wqkv", "wo") else "ffn"
        c = state["params"]["layers"][sub][name]
        path = ("layers", sub, name)
        for b in INEXACT_B:
            for tr in (False, True):
                d = c["g"].shape[-1 if tr else -2]
                x = torch.randn((c["g"].shape[0], b, d), generator=gen,
                                device="cuda")
                ws = torch.as_tensor(c["w_scale"], device="cuda").float() \
                    .expand(c["g"].shape[0]).contiguous()
                row = inexact_read_case(K, S, TM, path, x, c["g"], c["ref"],
                                        ws, xcfg, cfg, tr)
                if not row["within_bound"]:
                    fail(f"27(c) {name} B={b} transpose={tr}: a read is "
                         f"off the reassociation bound ({row})")
                reads.append(row)
    g0 = {"/".join(p): t.cpu() for p, t in leaves_of(state["params"])
          if p[-1] == "g"}
    step1 = TA.make_analog_sgd_step(cfg, lr=0.1)
    batch = tp_tokens(cfg.vocab, *TP_BATCH)
    one, _ = step1(state, batch, INEXACT_SEED_BASE)
    g1 = {"/".join(p): t.cpu() for p, t in leaves_of(one["params"])
          if p[-1] == "g"}
    del one
    # the yardsticks: the same one-device step with the embedding nudged
    # one ulp up, every element or a random half (the device-mode step is
    # chaotic: an ulp flips DAC and ADC codes downstream, and a rank-2048
    # write sums them)
    embed = state["params"]["embed"]
    up = torch.nextafter(embed, torch.tensor(float("inf"), device="cuda"))
    nudges = {}
    for seed in NUDGE_SEEDS:
        if seed is None:
            nudged = up
        else:
            pick = torch.Generator(device="cuda")
            pick.manual_seed(seed)
            half = torch.rand(embed.shape, generator=pick,
                              device="cuda") < 0.5
            nudged = torch.where(half, up, embed)
        two, _ = step1({**state, "params": {**state["params"],
                                            "embed": nudged}},
                       batch, INEXACT_SEED_BASE)
        nudges["all" if seed is None else f"half_{seed}"] = write_distance(
            {"/".join(p): t.cpu() for p, t in leaves_of(two["params"])
             if p[-1] == "g"}, g1, g0)
        del two, nudged
    yard = {k: max(n[k] for n in nudges.values()) for k in g1}
    wqkv = state["params"]["layers"]["attn"]["wqkv"]
    ranks = spawn_layout(8, "inexact")
    exact, loose, fault = (ranks[0][r] for r in ("exact", "inexact",
                                                  "fault"))
    # the exact step on 2x4 is the one-device step bit for bit
    sharded_off = sum(int((exact["g"][k] != g1[k]).sum()) for k in g1)
    if sharded_off:
        fail(f"27(c): the exact step on 2x4 differs from the one-device "
             f"step in {sharded_off} cells (losses {exact['loss']})")
    # the first read in the step: the same drive in every form
    x_e, y_e = exact["first"]
    bound = first_read_bound(K, cfg, xcfg, wqkv, x_e)
    bound = bound.reshape(y_e.shape).cpu() + 2.0 ** -23 * y_e.abs()
    first = {}
    for name, run in (("inexact", loose), ("fault", fault)):
        x_r, y_r = run["first"]
        err = (y_r - y_e).abs()
        first[name] = {"same_drive": bool(torch.equal(x_r, x_e)),
                       "block": run["first_block"],
                       "within_bound": bool((err <= bound).all()),
                       "worst_err_over_bound": float(
                           (err / bound.clamp_min(1e-30)).max()),
                       "elements_off": int((err > bound).sum())}
    del state, wqkv, embed, up
    diff = cells = unequal = 0
    for key, a in exact["g"].items():
        b = loose["g"][key]
        # the writes' scales move by float rounding with the reads: a
        # cell is off when it moves beyond 1e-4 of its own write (a
        # flipped operand code moves it by about one code step, 1e-2)
        off = (a - b).abs() > 1e-4 * (a - g0[key]).abs() + 1e-7
        diff += int(off.sum())
        unequal += int((a != b).sum())
        cells += a.numel()
    write_rel = write_distance(loose["g"], exact["g"], g0)
    fault_rel = write_distance(fault["g"], exact["g"], g0)
    limit = {k: WRITE_LIMIT * v for k, v in yard.items()}
    print(f"27(c) writes: {diff} of {cells} cells off, {unequal} not "
          f"bit-equal; write distance from the exact step's (2-norm, "
          f"relative): exact=False {write_rel}, planted fault {fault_rel}; "
          f"one-ulp nudges {nudges}; limit {WRITE_LIMIT} x the largest "
          f"nudge; losses exact {exact['loss']!r} / exact=False "
          f"{loose['loss']!r} / fault {fault['loss']!r}; first read "
          f"{first}", flush=True)
    if not all(f["same_drive"] for f in first.values()):
        fail(f"27(c): the steps' first reads saw different drives: {first}")
    if not first["inexact"]["within_bound"]:
        fail(f"27(c): the exact=False step's first read is off the "
             f"reassociation bound: {first['inexact']}")
    if first["fault"]["within_bound"]:
        fail(f"27(c): the planted fault's first read is within the bound: "
             f"the gate cannot see it ({first['fault']})")
    if abs(loose["loss"] - exact["loss"]) > 1e-3 * abs(exact["loss"]) \
            or any(v > limit[k] for k, v in write_rel.items()):
        fail(f"27(c): the exact=False step moved beyond the yardstick: "
             f"writes {write_rel} against the limit {limit}, losses "
             f"{exact['loss']} / {loose['loss']}")
    if not any(v > limit[k] for k, v in fault_rel.items()):
        fail(f"27(c): the planted fault's writes {fault_rel} are within the "
             f"limit {limit}: the write gate cannot see it")
    writes = ("update_tc", "update_prepare", "update_fp32")
    for i, r in enumerate(ranks):
        if any(r["exact"]["launches"].get(k) != r[v]["launches"].get(k)
               for k in writes for v in ("inexact", "fault")):
            fail(f"27(c) rank {i}: the writes' launches changed: "
                 f"{r['exact']['launches']} against "
                 f"{r['inexact']['launches']}")
    by_b = {b: {k: sum(r[k] for r in reads if r["B"] == b)
                for k in ("whole_ms", "exact_form_ms", "inexact_form_ms")}
            for b in INEXACT_B}
    row = {"reads": reads, "reads_within_bound": len(reads),
           "cells_off": diff, "cells_not_bit_equal": unequal,
           "cells": cells, "write_rel_2norm": write_rel,
           "write_rel_2norm_planted_fault": fault_rel,
           "write_rel_2norm_one_ulp_nudges": nudges,
           "write_limit": limit, "first_read": first,
           "loss": {"exact": exact["loss"], "inexact": loose["loss"],
                    "fault": fault["loss"]},
           "step_ms_per_rank": {run: [r[run]["ms"] for r in ranks]
                                for run in ("exact", "inexact", "fault")},
           "kernel_ms_by_B": by_b}
    print(f"27(c) exact=False on 2x4: {len(reads)} reads within the bound; "
          f"the step's first read at {first['inexact']['worst_err_over_bound']:.3g}"
          f" of the bound (the planted fault at "
          f"{first['fault']['worst_err_over_bound']:.3g}, "
          f"{first['fault']['elements_off']} elements off); "
          f"{diff} of {cells} cells off after one step ({unequal} not "
          f"bit-equal; loss "
          f"{exact['loss']:.6f} / {loose['loss']:.6f}); kernel ms summed "
          f"over the ranks and containers, whole / exact form / exact=False "
          + "; ".join(f"B={b}: {v['whole_ms']:.2f} / {v['exact_form_ms']:.2f}"
                      f" / {v['inexact_form_ms']:.2f}"
                      for b, v in by_b.items())
          + f" (phase 24(b) on an H100: the exact form 4.1-5.9x the whole "
          f"read at B=2048) [{gpu_line}]")
    report(row)
    return row


API_CONTAINERS = (("wqkv", 768, 2304), ("w_down", 3072, 768))
API_LAYERS = 12
API_READ_B = (4, 2048)
API_T = 2048
API_FQ_ROWS = 1024
API_SEED = 0x31313131


def launched(module, before, *names):
    """Launches of ``names`` in ``module.LAUNCHES`` since ``before``."""
    return {n: module.LAUNCHES[n] - before[n] for n in names}


def api_reads(K, OPS, XO, CrossbarConfig, AdcConfig, TAOX_NONOISE, gen):
    """Phase 31(a) and (d): reads with the flag against the reads without
    it, and ``kernels.ops`` against ``core.xbar_ops``, bit for bit."""
    rows = []
    adc = AdcConfig(range_mode="dynamic")
    cfg = CrossbarConfig(rows=64, cols=64, adc=adc, device=TAOX_NONOISE)
    sr = cfg.replace(adc=AdcConfig(range_mode="dynamic",
                                   stochastic_round=True))
    for name, k, n in API_CONTAINERS:
        w = torch.randn((API_LAYERS, k, n), generator=gen,
                        device="cuda") / math.sqrt(k)
        w_max = w.abs().amax(dim=(1, 2))
        g = 0.5 + w * (0.5 / w_max)[:, None, None]
        ref = torch.full_like(g, 0.5)
        ws = 0.5 / w_max
        for b in API_READ_B:
            for transpose in (False, True):
                x = torch.randn((API_LAYERS, b, k if not transpose else n),
                                generator=gen, device="cuda")
                d = "mvm" if transpose else "vmm"
                before = dict(K.LAUNCHES)
                on = K.xbar_fused_read(x, g, ref, ws, sr, transpose=transpose)
                one = launched(K, before, f"fused_{d}")[f"fused_{d}"]
                off = K.xbar_fused_read(x, g, ref, ws, cfg,
                                        transpose=transpose)
                core = (XO.mvm if transpose else XO.vmm)(x, g, ref, ws, cfg)
                ops = (OPS.mvm if transpose else OPS.vmm)(x, g, ref, ws, cfg)
                torch.cuda.synchronize()
                count = launched(K, before, f"fused_{d}")[f"fused_{d}"]
                row = {"gate": "31(a,d)", "container": name, "B": b,
                       "transpose": transpose, "instance":
                       K.read_instance(b, adc.in_levels),
                       "flag_bit_equal": torch.equal(on, off),
                       "ops_bit_equal": torch.equal(ops, core)
                       and torch.equal(ops, off), "launches": count}
                rows.append(row)
                if not (row["flag_bit_equal"] and row["ops_bit_equal"]) \
                        or one < 1 or count != 4 * one:
                    fail(f"phase 31(a)/(d): {row}")
        del w, g, ref
    for name, k, n in API_CONTAINERS:
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        for t in API_READ_B:
            x = torch.randn((t, k), generator=gen, device="cuda")
            before = dict(K.LAUNCHES)
            on = K.fakequant_read(x, w, AdcConfig(stochastic_round=True),
                                  API_FQ_ROWS)
            off = K.fakequant_read(x, w, AdcConfig(), API_FQ_ROWS)
            torch.cuda.synchronize()
            count = launched(K, before, "fakequant")["fakequant"]
            row = {"gate": "31(a)", "container": name, "T": t,
                   "fakequant": True, "instance":
                   K.fakequant_instance(t, AdcConfig().in_levels),
                   "flag_bit_equal": torch.equal(on, off),
                   "launches": count}
            rows.append(row)
            if not row["flag_bit_equal"] or count != 2:
                fail(f"phase 31(a): {row}")
    return rows


def api_lut_writes(U, CrossbarConfig, TAOX, gen):
    """Phase 31(b): ``kind="lut"`` writes bit-equal to ``kind="taox"``
    at the same seed, both modes, both instances."""
    rows = []
    lut = TAOX.replace(kind="lut")
    for name, k, n in API_CONTAINERS:
        g, x_q, d_q, scale, xs, ds = update_operands(API_LAYERS, k, n, API_T,
                                                     gen, False)
        for mode in ("outer", "pulse_train"):
            for inst in ("tensor_core", "fp32"):
                scales = dict(x_scale=xs, d_scale=ds) \
                    if inst == "tensor_core" else {}
                outs = []
                before = dict(U.LAUNCHES)
                for dev in (lut, TAOX):
                    cfg = CrossbarConfig(rows=64, cols=64, device=dev,
                                         update_mode=mode)
                    outs.append(U.xbar_outer_update(
                        g, x_q, d_q, scale, cfg, seed=API_SEED,
                        noise_mode="kernel", **scales))
                torch.cuda.synchronize()
                kern = "update_tc" if inst == "tensor_core" else "update_fp32"
                count = launched(U, before, kern)[kern]
                row = {"gate": "31(b)", "container": name, "mode": mode,
                       "instance": inst,
                       "bit_equal": torch.equal(outs[0], outs[1]),
                       "moved": (outs[0] - g).abs().max().item(),
                       "launches": count}
                rows.append(row)
                if not row["bit_equal"] or count != 2:
                    fail(f"phase 31(b): {row}")
                del outs
        del g, x_q, d_q
    return rows


def api_outer_update(U, OPS, XO, CrossbarConfig, TAOX, gen):
    """Phase 31(c): ``kernels.ops.outer_update`` on float operands, host
    and kernel noise, against its plain version in the write's class, and
    timed beside the direct write of the same quantised operands."""
    rows = []
    sync = torch.cuda.synchronize
    cfg = CrossbarConfig(rows=64, cols=64, device=TAOX)
    lr = 0.1
    for name, k, n in API_CONTAINERS:
        g = (0.5 + 0.1 * torch.randn((API_LAYERS, k, n), generator=gen,
                                     device="cuda")).clamp(0, 1)
        x = torch.randn((API_LAYERS, API_T, k), generator=gen, device="cuda")
        d = 1e-3 * torch.randn((API_LAYERS, API_T, n), generator=gen,
                               device="cuda")
        ws = 1.5 + 0.5 * torch.rand((API_LAYERS,), generator=gen,
                                    device="cuda")
        x_int, xs, d_int, ds = XO.quantize_update_codes(x, d, cfg)
        x_q, d_q = x_int * xs, d_int * ds
        scale = torch.as_tensor(-lr, dtype=torch.float32, device="cuda") * ws
        xs_l, ds_l = xs.expand(API_LAYERS), ds.expand(API_LAYERS)
        for mode in ("host", "kernel"):
            z = torch.randn(g.shape, generator=gen, device="cuda") \
                if mode == "host" else None
            noise = dict(noise=z) if mode == "host" else dict(seed=API_SEED)
            before = dict(U.LAUNCHES)
            g_k = OPS.outer_update(g, x, d, lr, ws, cfg, noise_mode=mode,
                                   **noise)
            sync()
            count = launched(U, before, "update_tc", "update_prepare",
                             "update_fp32")
            seed = API_SEED if mode == "kernel" else None
            g_p = U._update_plain(g, x_q, d_q, scale, z, seed, cfg, mode)
            g_x = U._update_tc_plain(g, x_q, d_q, scale, z, seed, cfg, mode,
                                     xs_l, ds_l)
            field = z if mode == "host" else U.field_normals(
                seed, g.shape, cfg, device="cuda")
            ok, err, over, share = tc_write_agrees(g_k, g_p, g_x, g, x_q,
                                                   d_q, scale, cfg, field)
            del g_p, g_x, field
            row = {"gate": "31(c)", "container": name, "noise_mode": mode,
                   "L": API_LAYERS, "K": k, "N": n, "T": API_T,
                   "ok": ok and share < SUM_TIE_SHARE,
                   "max_abs_err": err, "max_err_over_twin_bound": over,
                   "allowance_share": share, "launches": count,
                   "moved": (g_k - g).abs().max().item()}
            del g_k
            if not row["ok"] or count != {"update_tc": 1,
                                          "update_prepare": 1,
                                          "update_fp32": 0}:
                fail(f"phase 31(c): ops.outer_update disagrees with its "
                     f"plain version or left the tensor-core instance: "
                     f"{row}")
            row["ms"] = cuda_ms(lambda i: OPS.outer_update(
                g, x, d, lr, ws, cfg, noise_mode=mode, **noise), 5, sync)
            row["direct_ms"] = cuda_ms(lambda i: U.xbar_outer_update(
                g, x_q, d_q, scale, cfg, noise_mode=mode, x_scale=xs,
                d_scale=ds, **noise), 5, sync)
            row["quantise_ms"] = cuda_ms(
                lambda i: XO.quantize_update_codes(x, d, cfg), 5, sync)
            rows.append(row)
            print(f"  ops.outer_update {name} (L {API_LAYERS}, K {k}, N {n}) "
                  f"T={API_T} {mode} noise: {row['ms']:.3f} ms; direct "
                  f"xbar_outer_update of the quantised operands "
                  f"{row['direct_ms']:.3f} ms; the quantisation alone "
                  f"{row['quantise_ms']:.3f} ms; max abs err "
                  f"{row['max_abs_err']:.3g} (cells moved up to "
                  f"{row['moved']:.3g}), allowance share {share:.2g}")
            del z
        del g, x, d, x_q, d_q
    return rows


def phase_api(K, U, OPS, XO, CrossbarConfig, AdcConfig, TAOX, TAOX_NONOISE,
              report, gpu_line):
    """Phase 31 (see the module docstring): every gate fails the run."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    out = {"reads": api_reads(K, OPS, XO, CrossbarConfig, AdcConfig,
                              TAOX_NONOISE, gen),
           "lut": api_lut_writes(U, CrossbarConfig, TAOX, gen),
           "ops_outer_update": api_outer_update(U, OPS, XO, CrossbarConfig,
                                                TAOX, gen)}
    for rows in out.values():
        for r in rows:
            report(r)
    n_reads = sum(r["flag_bit_equal"] for r in out["reads"])
    print(f"phase 31: {n_reads} reads with stochastic_round bit-equal to "
          f"the flag off, {sum(r['bit_equal'] for r in out['lut'])} lut "
          f"writes bit-equal to taox, {len(out['ops_outer_update'])} "
          f"ops.outer_update cases in the write's class ({gpu_line})")
    return out


def api_entry(api, kernel):
    """The kernels-line figures of phase 31 for one kernel."""
    if kernel == "fakequant":
        return {"stochastic_round_31a": sum(
            r["flag_bit_equal"] for r in api["reads"] if r.get("fakequant"))}
    if kernel in ("vmm", "mvm"):
        rs = [r for r in api["reads"] if not r.get("fakequant")
              and r["transpose"] == (kernel == "mvm")]
        return {"stochastic_round_31a": sum(r["flag_bit_equal"] for r in rs),
                "ops_bit_equal_31d": sum(r["ops_bit_equal"] for r in rs)}
    mode = "pulse_train" if kernel == "pulse" else "outer"
    out = {"lut_bit_equal_31b": sum(r["bit_equal"] for r in api["lut"]
                                    if r["mode"] == mode)}
    if kernel == "outer":
        out["ops_outer_update_31c"] = [
            {key: r[key] for key in ("container", "noise_mode", "ms",
                                     "direct_ms", "quantise_ms",
                                     "max_abs_err", "allowance_share")}
            for r in api["ops_outer_update"]]
    return out


def tp_split_entry(rows, case="split"):
    """The kernels-line figures of the split-range read (``case``
    ``split``) or the tiles read (``tiles``) of phase 27(a): its
    launches in the layouts' steps, summed over the ranks; the error and
    times of rank 0's read on 2x2 (2048 tokens; 768 x 1152 of lm100m's
    wqkv, or 1536 x 768 of its w_down; the gather over the ranks left out
    of the times)."""
    main = rows[0][case][0]
    key = f"{case}_reads_per_rank"
    return {"launches": sum(sum(r[key]) for r in rows),
            "launches_per_rank": {r["layout"]: r[key] for r in rows},
            "max_abs_err": max(sp["max_abs_err"] for r in rows
                               for sp in r[case]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "tc_floor_ms": main["tc_floor_ms"], "library_ms": None}


def family_launches(rows, case):
    """Phase 29(a)-(c)'s split-range (``case`` ``split``) or tiles reads
    in the steps of every layout, summed over the ranks, by model."""
    out = {}
    for r in rows:
        out[r["arch"]] = out.get(r["arch"], 0) + sum(
            r[f"{case}_reads_per_rank"])
    return out


def mlp_read_entry(mlp, direction, names):
    """The kernels-line figures of the MLP's reads in one direction: the
    launches of phase 14(b)'s six runs (each kernel counted) and the
    B = 10 read times (phase 14, summed over ``names``: one training
    step's reads in that direction, one of each layer)."""
    by = {}
    for row in mlp["runs"]:
        for key, v in row["launches"].items():
            if key.endswith(f"_{direction}"):
                by[key] = by.get(key, 0) + v
    reads = [mlp["reads"][n] for n in names]
    return {"launches_mlp": by.get(f"fused_{direction}", 0),
            "launches_by_kernel_mlp": by,
            "mlp_b10_max_abs_err": max(r["max_abs_err"] for r in reads),
            "mlp_b10_ms": sum(r["ms"] for r in reads),
            "mlp_b10_plain_ms": sum(r["plain_ms"] for r in reads),
            "mlp_b10_bound_ms": sum(r["bound_ms"] for r in reads),
            "mlp_b10_bound_by": "bytes"}


def write_entry(rows, launches, hybrid=None):
    """The kernels-line figures of a write's tensor-core instance, summed
    over ``rows`` (the four containers' timed writes), with its FP32
    instance's beside them (``fp32_instance``: 0 launches on lm100m's
    main path; with ``hybrid``, phase 21(b)'s result, its launches there,
    the hybrid shared block's writes, and their device time in the
    profiled step)."""
    def tot(key):
        return sum(r[key] for r in rows)
    bmm = ("accumulates_bmm_ms_not_the_same_function"
           if "accumulates_bmm_ms_not_the_same_function" in rows[0]
           else "accumulate_bmm_ms_not_the_same_function")
    return {
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"),
        "bound_ms": tot("bound_ms"),
        "bound_by": "bytes" if tot("bytes_ms") >= tot("tc_operations_ms")
        else "operations",
        "library_ms": None,
        "design_ms": tot("design_ms"), "fp32_bound_ms": tot("fp32_bound_ms"),
        bmm: tot(bmm),
        "fp32_instance": {
            "name": "update_kernel (FP32 cores)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/xbar_update.cu",
            "launches": 0,
            "max_abs_err": max(r["fp32_max_abs_err"] for r in rows),
            "ms": tot("fp32_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("fp32_bound_ms"), "bound_by": "operations",
            "library_ms": None,
            **({} if hybrid is None else {
                "launches_zamba2_1_2b_train":
                    hybrid["launches"]["update_fp32"],
                "zamba2_1_2b_shared_writes_ms":
                    hybrid["shared_fp32_writes_ms"]})}}


def moe_expert_entry(rows):
    """The kernels-line figures of 28(a)'s expert-stack reads on data
    ranks: their launches in the steps of the layouts with data ranks
    (2x2, 4x1: every fakequant read of an expert stack, summed over the
    ranks), the error over every data rank's case, the times and bound of
    rank 0's on 4x1 (64 experts x 240 rows x 2048 x 1408, w_up's
    shapes; the four ranks time theirs at once on this card)."""
    rows = [r for r in rows if r["expert"]]
    cases = [c for r in rows for c in r["expert"]]
    main = next(r for r in rows if r["layout"] == "4x1")["expert"][0]
    return {"launches": sum(r["expert_reads_per_rank"] * len(r["ms_per_rank"])
                            for r in rows),
            "launches_per_rank": {r["layout"]: r["expert_reads_per_rank"]
                                  for r in rows},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "tc_floor_ms": main["tc_floor_ms"], "library_ms": None,
            "instance": main["instance"],
            "bit_equal_whole_rows": all(c["bit_equal_whole_rows"]
                                        for c in cases)}


def fq_rows_of(rows, t, instance):
    """The timed fakequant rows of one lm100m layer's four projections at
    ``t`` tokens on ``instance``."""
    names = {name for name, _, _ in TRAIN_SHAPES}
    return [r for r in rows if r["T"] == t and "ms" in r
            and r["instance"] == instance and r["projection"] in names]


def fq_entry(rows):
    """The kernels-line figures of a fakequant instance, summed over one
    layer's four reads (``rows``)."""
    def tot(key):
        return sum(r[key] for r in rows)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if tot("bytes_ms") >= tot("bound_ms")
            else "operations",
            "tc_floor_ms": tot("tc_floor_ms"),
            "matmul_ms_not_the_same_function": tot(
                "matmul_ms_not_the_same_function"),
            "prepass_ms": tot("prepass_ms"), "product_ms": tot("product_ms"),
            "epilogue_ms": tot("epilogue_ms")}


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port's package is missing under {ROOT / 'src'}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import (IDEAL, TAOX, TAOX_NONOISE, AdcConfig,
                                  CrossbarConfig)
    from repro_torch.core import endurance as E
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import xbar_update as U
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.core import tiled_analog as TT
    from repro_torch.models import model as M
    from repro_torch.models import moe as TMoE
    from repro_torch.models import ssm as TS
    from repro_torch.serve import SamplingParams, make_engine
    from repro_torch.hwmodel import compare as CMP
    from repro_torch.launch import accuracy as ACC
    from repro_torch.train import analog_lm as TA
    from repro_torch.train import mlp_analog as MLP
    from repro_torch.train import optimizer as TO
    from repro_torch.train import train_loop as TL
    from repro_torch.launch import mesh as TM
    from repro_torch.launch import sharding as S
    from repro_torch.kernels import ref as REF
    from repro_torch.analysis import kernel_lint as KL
    from repro_torch.launch import dryrun as DR
    from repro_torch.core import xbar_ops as XO

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr}")
    gpu_line = smi.stdout.strip().splitlines()[0]
    print(gpu_line)
    details = {"gpu": gpu_line, "torch": torch.__version__,
               "cuda": torch.version.cuda, "phases": {}}

    def reporter(name):
        details["phases"].setdefault(name, [])
        return details["phases"][name].append

    t0 = time.perf_counter()
    sources = [K.SOURCE, U.SOURCE, K.FAKEQUANT_SOURCE, FA.SOURCE]
    _nvcc.build(sources)                  # one nvcc per source, together
    K._library()
    U._library()
    K._fakequant_library()
    FA._library()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _nvcc.BUILD_LOGS.items()}
    print(f"built {', '.join(s.name for s in sources)} in {build_s:.1f} s; "
          + " | ".join(f"{n}: " + "; ".join(v) for n, v in ptxas.items()))
    details["build"] = {"seconds": build_s, "ptxas": ptxas,
                        "hmma": tensor_core_check(
                            _nvcc, (K.SOURCE, U.SOURCE, K.FAKEQUANT_SOURCE,
                                    FA.SOURCE))}

    def cfg_of(tile, cls):
        adc = {"pow2": AdcConfig(range_mode="fixed", sat_frac=0.03125),
               "dynamic": AdcConfig(range_mode="dynamic"),
               "dac12": AdcConfig(in_bits=12, range_mode="dynamic")}[cls]
        return CrossbarConfig(rows=tile, cols=tile, adc=adc,
                              device=TAOX_NONOISE)

    seconds = details["phase_seconds"] = {"build": build_s}

    @contextlib.contextmanager
    def phase(name):
        """Time phase ``name`` (wall seconds, the card synchronised at its
        end) and print it on a line of its own."""
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        print(f"phase {name} took {seconds[name]:.1f} s of wall time")

    # phases 1-25 run without per-layer remat, as in the runs before it
    # existed (their gates, launch counts and times stay comparable);
    # phase 26 runs the policies
    no_remat = contextlib.ExitStack()
    no_remat.enter_context(env_set("REPRO_REMAT", "none"))
    with phase("1"):
        profiler_warmup()
        rows = phase_kernel(K, cfg_of, reporter("kernel"))
        for r in rows:
            if "ms" in r:
                print_read_time("VMM", r)
        print(f"phase 1: {len(rows)} kernel-vs-plain cases agree")

    acfg = get_config("lm100m").replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox-nonoise", analog_rows=64, analog_cols=64)
    dcfg = get_config("lm100m")
    with phase("2"):
        params, aparams, prompts, serve = phase_serve(
            M, K, make_engine, SamplingParams, acfg, dcfg,
            reporter("serve"))
    with phase("3"):
        phase_card_vs_cpu(M, K, acfg, params, aparams, reporter("card_cpu"))
    with phase("4"):
        phase_profile(M, acfg, aparams, reporter("profile"))
        phase_default_tiles(M, K, acfg, params, reporter("default_tiles"))
    with phase("5"):
        mvm_rows = phase_mvm(K, cfg_of, reporter("mvm"))

    def xcfg_of(case):
        return CrossbarConfig(rows=64, cols=64,
                              device=IDEAL if case == "ideal" else TAOX)
    with phase("6"):
        upd_rows = phase_update(U, TAOX, CrossbarConfig, xcfg_of,
                                reporter("update"))
    tcfg = get_config("lm100m").replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox", analog_rows=64, analog_cols=64)
    with phase("7"):
        train = phase_train(K, U, TA, M, syn, tcfg, reporter("train"))

    with phase("8"):
        fq_rows = phase_fq_kernel(K, AdcConfig, reporter("fakequant_kernel"))
    fcfg = get_config("lm100m").replace(dtype="float32", analog=True,
                                        analog_mode="fakequant")
    with phase("9"):
        fparams, fq_serve = phase_fq_serve(M, K, OPS, make_engine,
                                           SamplingParams, fcfg, prompts,
                                           reporter("fakequant_serve"))
        print(f"serving tokens/s in this run: fakequant "
              f"{fq_serve['tokens_per_s']:.1f}, device mode (phase 2) "
              f"{serve['tokens_per_s']:.1f}")
    with phase("10"):
        phase_fq_card_vs_cpu(M, K, OPS, fcfg, fparams,
                             reporter("fakequant_card_cpu"))
        fq_prefill = phase_fq_prefill(M, K, OPS, fcfg, fparams,
                                      reporter("fakequant_prefill"))
    del fparams
    with phase("11"):
        fa_rows, fa_launches = phase_flash(FA, reporter("flash_attention"))
    with phase("12"):
        pulse_rows = phase_pulse_update(U, TAOX, IDEAL, CrossbarConfig,
                                        reporter("pulse_update"))
    with phase("13"):
        carry = phase_carry_train(K, U, TA, M, syn, tcfg,
                                  reporter("carry_train"))
        phase_nonideality(U, K, TA, TL, TO, M, syn, tcfg,
                          reporter("nonideality"), steps=30)
    with phase("14"):
        # 14(b) on launch.accuracy's --fast protocol since phase 32 joined
        # (the six full-protocol runs took 105-152 s of host time)
        mlp = phase_mlp(K, U, MLP, ACC, CMP, syn, reporter("mlp"), train,
                        fast=True)
    del params, aparams
    with phase("15"):
        gemma = phase_gemma(M, K, E, make_engine, SamplingParams, get_config,
                            reporter("gemma_2b"))
    with phase("16"):
        dense = {name: phase_dense_serve(M, K, make_engine, SamplingParams,
                                         get_config, name, 2,
                                         reporter(f"dense_{name}"))
                 for name in ("stablelm-3b", "granite-20b")}
        dense_train = phase_dense_train(K, U, TA, syn, get_config,
                                        reporter("dense_train"))
    with phase("17"):
        qat = phase_qat(K, OPS, M, TL, TO, syn, get_config, reporter("qat"))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 1e9
    print(f"phase 18 starts with {before:.2f} GB allocated on the card")
    details["moe_start_allocated_gb"] = before
    with phase("18"):
        moe_serve = phase_moe_serve(M, K, TT, TMoE, make_engine,
                                    SamplingParams, get_config,
                                    reporter("moe_serve"))
        moe_fq_rows = phase_moe_fq_kernel(K, AdcConfig,
                                          reporter("moe_fakequant_kernel"))
        moe_fq = phase_moe_fq_serve(M, K, OPS, TMoE, make_engine,
                                    SamplingParams, get_config,
                                    reporter("moe_fakequant_serve"))
        moe_train = phase_moe_train(K, U, TA, TMoE, syn, get_config,
                                    reporter("moe_train"))
    with phase("19"):
        mla_serve = phase_mla_serve(M, K, TT, TMoE, make_engine,
                                    SamplingParams, get_config,
                                    reporter("mla_serve"))
        mla_fq = phase_mla_fq_serve(M, K, OPS, TT, TMoE, make_engine,
                                    SamplingParams, get_config,
                                    reporter("mla_fakequant_serve"))
        mla_train = phase_moe_train(K, U, TA, TMoE, syn, get_config,
                                    reporter("mla_train"), arch=MLA_ARCH,
                                    n_layers=MLA_TRAIN_LAYERS, label="19(c)")
    with phase("20"):
        ssm_serve = phase_ssm_serve(M, K, TT, TMoE, make_engine,
                                    SamplingParams, get_config, SSM_ARCH,
                                    reporter("ssm_serve"), "20(a)")
        ssm_fq = phase_ssm_fq_serve(M, K, OPS, TT, TMoE, make_engine,
                                    SamplingParams, get_config,
                                    reporter("ssm_fakequant_serve"))
        ssm_train = phase_ssm_train(K, U, TA, TS, syn, get_config,
                                    reporter("ssm_train"), SSM_ARCH,
                                    SSM_TRAIN_LAYERS, "20(c)")
    with phase("21"):
        hybrid_serve = phase_ssm_serve(M, K, TT, TMoE, make_engine,
                                       SamplingParams, get_config,
                                       HYBRID_ARCH, reporter("hybrid_serve"),
                                       "21(a)")
        phase_shared_write_kernel(U, IDEAL, CrossbarConfig,
                                  reporter("shared_write_kernel"))
        hybrid_train = phase_ssm_train(K, U, TA, TS, syn, get_config,
                                       reporter("hybrid_train"), HYBRID_ARCH,
                                       HYBRID_TRAIN_LAYERS, "21(b)")
    serving = (M, K, TT, TMoE, OPS, make_engine, SamplingParams, get_config)
    with phase("22"):
        audio_serve = phase_cross_serve(*serving, AUDIO_ARCH, AUDIO_LAYERS,
                                        reporter("audio_serve"), "22(a)")
        audio_fq = phase_cross_fq_serve(*serving, AUDIO_ARCH, AUDIO_LAYERS,
                                        reporter("audio_fakequant_serve"),
                                        "22(b)")
        audio_train = phase_cross_train(K, U, TA, M, syn, get_config,
                                        reporter("audio_train"), AUDIO_ARCH,
                                        AUDIO_LAYERS, "22(c)")
    with phase("23"):
        vlm_serve = phase_cross_serve(*serving, VLM_ARCH, VLM_SERVE_LAYERS,
                                      reporter("vlm_serve"), "23(a)")
        vlm_fq = phase_cross_fq_serve(*serving, VLM_ARCH, VLM_FQ_LAYERS,
                                      reporter("vlm_fakequant_serve"),
                                      "23(b)")
        vlm_train = phase_cross_train(K, U, TA, M, syn, get_config,
                                      reporter("vlm_train"), VLM_ARCH,
                                      VLM_TRAIN_LAYERS, "23(c)")
    cross = {"whisper_medium": (audio_serve, audio_fq, audio_train),
             "llama_3_2_vision_90b": (vlm_serve, vlm_fq, vlm_train)}
    with phase("24"):
        shard_writes = phase_shard_writes(U, S, TM, TAOX, CrossbarConfig,
                                          get_config,
                                          reporter("shard_writes"))
        shard_reads = phase_shard_reads(K, S, TM, CrossbarConfig, AdcConfig,
                                        TAOX_NONOISE, get_config, gpu_line,
                                        reporter("shard_reads"))
        shard_cli = phase_shard_cli(reporter("shard_cli"), gpu_line)
    with phase("25"):
        bitplanes = phase_bitplanes(K, REF, CrossbarConfig, AdcConfig, IDEAL,
                                    reporter("bitplanes"))
        coverage = phase_coverage(KL, reporter("coverage"), gpu_line)
        dryrun = phase_dryrun(M, TL, TO, DR, get_config, reporter("dryrun"),
                              gpu_line)
    details["dryrun_25c"] = dryrun
    no_remat.close()
    with phase("26"):
        remat_lm = phase_remat_train(K, U, TA, syn, tcfg,
                                     reporter("remat_train"), gpu_line)
        remat_dry = phase_remat_dryrun(M, K, TL, TO, DR, get_config,
                                       reporter("remat_dryrun"), gpu_line)
        remat_deep = phase_remat_deep(K, U, TA, syn, get_config,
                                      reporter("remat_deep"), gpu_line)
        remat_hybrid = phase_remat_hybrid(K, U, TA, syn, get_config,
                                          reporter("remat_hybrid"), gpu_line)
        phase_prefill_head(M, get_config, reporter("prefill_head"),
                           gpu_line)

    # 32(a): the one-device serving runs whose logits and tokens phase
    # 32(b)'s ranks (started by 27(a), then=) hold themselves against
    try:
        with phase("32a"):
            serve_one = phase_serve_one(M, K, get_config,
                                        reporter("serve_one"), gpu_line)
        # 27(a)'s ranks go on to 27(b) and 32(b) (their seconds here too)
        with phase("27a"):
            tp_qat = phase_tp_qat(K, TL, TO, get_config, reporter("tp_qat"),
                                  gpu_line, then=("gemma", "serve32"))
    finally:
        for arch, _ in SERVE_ARCHS:
            serve_ref(arch).unlink(missing_ok=True)
    with phase("27bc"):
        tp_gemma = phase_tp_gemma(M, TL, TO, DR, S, TM, get_config,
                                  reporter("tp_gemma"), gpu_line)
        tp_inexact = phase_tp_inexact(K, S, TM, TA, syn, get_config,
                                      reporter("tp_inexact"), gpu_line)
    details["tp_27"] = {"qat": [{k: v for k, v in r.items()}
                                for r in tp_qat],
                        "gemma": tp_gemma,
                        "inexact": {k: v for k, v in tp_inexact.items()}}

    # phases 28 and 29 keep their 1x1 steps' parameters for phase 30
    refs = contextlib.ExitStack()
    refs.callback(lambda: [path.unlink(missing_ok=True) for path in
                           [MOE_REF] + [family_ref(a)
                                        for _, a, _ in FAMILY_CASES]])
    with refs:
        with phase("28"):
            moe_qat, moe_drop = phase_moe_qat(
                M, K, TL, TO, get_config, reporter("moe_qat"), gpu_line,
                keep_ref=True,
                then=(f"scout{'x'.join(map(str, SCOUT_LAYOUT))}",))
            moe_scout = phase_moe_scout(M, TL, DR, S, TM, get_config,
                                        reporter("moe_scout"), gpu_line)
        details["moe_28"] = {"qat": moe_qat, "drop": moe_drop,
                             "scout": moe_scout}

        with phase("29"):
            family = phase_family_qat(K, TL, TO, get_config,
                                      reporter("family_qat"), gpu_line,
                                      keep_ref=True,
                                      then=("vlm1x4", "seq30"))
            family_vlm = phase_family_vlm(M, DR, S, TM, get_config,
                                          reporter("family_vlm"), gpu_line)
        details["family_29"] = {"qat": family, "vlm": family_vlm}

        with phase("30"):
            seq_rows, seq_vlm = phase_seq(get_config, moe_qat, family,
                                          family_vlm, reporter("seq"),
                                          gpu_line)
        details["seq_30"] = {"qat": seq_rows, "vlm": seq_vlm}

    with phase("31"):
        api = phase_api(K, U, OPS, XO, CrossbarConfig, AdcConfig, TAOX,
                        TAOX_NONOISE, reporter("api"), gpu_line)
    with phase("32"):
        serve_rows, serve_reads = phase_serve_parallel(
            DR, TM, get_config, serve_one, reporter("serve_parallel"),
            gpu_line)
    details["serve_32"] = {"one": serve_one, "layouts": serve_rows,
                           "reads": serve_reads}

    def remat_launches(name):
        """The kernels-line figures of phase 26 for one launch count."""
        return {"launches_lm100m_train_remat_26a": {
                    pol: remat_lm[pol]["launches"][name]
                    for pol in REMAT_POLICIES},
                "launches_starcoder2_3b_train_full_depth_26c":
                    remat_deep["launches"][name],
                "launches_zamba2_1_2b_train_remat_26d": {
                    pol: remat_hybrid[pol]["launches"][name]
                    for pol in ("none", "full")}}

    def bitplane_cases(transpose):
        """The kernels-line figures of phase 25(a) for one direction."""
        rs = [r for r in bitplanes if r["transpose"] == transpose]
        return {inst: sum(r["bit_equal"] for r in rs
                          if r["instance"] == inst) for inst in BITPLANE_B}

    def covered(name):
        """The kernels-line figures of phase 25(b) for one kernel."""
        rs = [r for r in coverage if r["kernel"] == name]
        return {"cases_clean": sum(not r["unwritten"]
                                   and not r["guard_touched"]
                                   and r["bit_equal"] for r in rs),
                "cases": [r["case"] for r in rs]}

    def sharded_reads(transpose):
        """The kernels-line figures of phase 24(b) for one direction."""
        rs = [r for r in shard_reads if r["transpose"] == transpose]

        def summed(sel, k):   # None where the profiler recorded no kernel
            vals = [r[k] for r in rs if sel(r)]
            return None if None in vals else sum(vals)
        return {"cases_bit_equal": sum(r["bit_equal"] for r in rs),
                **{f"B{b}_{k}": summed(lambda r: not r["expert"]
                                      and r["B"] == b, k)
                   for b in SHARD_READ_B for k in SHARD_READ_TIMES},
                **{f"expert_{k}": summed(lambda r: r["expert"], k)
                   for k in SHARD_READ_TIMES}}

    def sharded_writes(mode):
        """The kernels-line figures of phase 24(a) for one update mode."""
        rs = [r for r in shard_writes if r["mode"] == mode]
        return {"cases_bit_equal": sum(r["bit_equal"] for r in rs),
                "blocks": sum(r["blocks"] for r in rs)}

    def cross_launches(kind):
        """The kernels-line figures of phases 22-23 for one kernel."""
        out = {}
        for n, (srv, fq, trn) in cross.items():
            if kind == "vmm":
                out[f"launches_{n}"] = srv["serve"]["reads"]
                out[f"launches_by_kernel_{n}"] = \
                    srv["serve"]["launches_by_kernel"]
            if kind == "fakequant":
                out[f"launches_{n}"] = fq["serve"]["reads"]
                out[f"launches_{n}_tensor_core"] = \
                    fq["serve"]["tensor_core_reads"]
                continue
            key = {"vmm": "fused_vmm", "mvm": "fused_mvm"}.get(kind, kind)
            out[f"launches_{n}_train"] = trn["launches"][key]
        return out

    def total(launches, name):
        return sum(step[name] for step in launches)
    decode = [r for r in rows if r.get("B") == 4 and "ms" in r]
    t_mvm = [r for r in mvm_rows if r.get("B") == 2048 and "ms" in r]
    t_upd = [r for r in upd_rows if "ms" in r]
    tl = train["launches_per_step"]
    fq_decode = fq_rows_of(fq_rows, 4, "fp32")
    fa_main = next(r for r in fa_rows
                   if r["case"] == "lm100m" and r["dtype"] == "float32")
    fa_bf16 = next(r for r in fa_rows
                   if r["case"] == "lm100m" and r["dtype"] == "bfloat16")
    t_pulse = [r for r in pulse_rows if "ms" in r]
    t_vmm = [r for r in rows if r.get("B") == 2048 and "ms" in r]

    n_vmm, n_mvm = total(tl, "fused_vmm"), total(tl, "fused_mvm")
    kernels = [{
        "name": "xbar_fused_vmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xbar_vmm.cu",
        "replaces": "src/repro/kernels/xbar_vmm.py:148",
        "launches": serve["launches"],
        "launches_by_kernel": serve["launches_by_kernel"],
        "launches_train": n_vmm,
        "launches_by_kernel_train": read_kernel_launches(tl, "vmm"),
        "max_abs_err": max(r["max_abs_err"] for r in decode),
        "ms": sum(r["ms"] for r in decode),
        "plain_ms": sum(r["plain_ms"] for r in decode),
        "bound_ms": sum(r["bound_ms"] for r in decode),
        "bound_by": "bytes", "library_ms": None,
        "train_ms": sum(r["ms"] for r in t_vmm),
        "train_plain_ms": sum(r["plain_ms"] for r in t_vmm),
        "train_bound_ms": sum(r["bound_ms"] for r in t_vmm),
        "train_tc_floor_ms": sum(r["tc_floor_ms"] for r in t_vmm),
        "train_tc_design_ms": sum(r["tc_design_ms"] for r in t_vmm),
        "launches_gemma_2b": gemma["serves"]["first"]["reads"],
        "launches_by_kernel_gemma_2b":
            gemma["serves"]["first"]["launches_by_kernel"],
        **{f"launches_{n}": d["reads"] for n, d in dense.items()},
        "launches_starcoder2_3b_train":
            dense_train["launches"]["fused_vmm"],
        "launches_llama4_scout": moe_serve["serve"]["reads"],
        "launches_llama4_scout_train": moe_train["launches"]["fused_vmm"],
        "launches_deepseek_v2_lite": mla_serve["serve"]["reads"],
        "launches_by_kernel_deepseek_v2_lite":
            mla_serve["serve"]["launches_by_kernel"],
        "launches_deepseek_v2_lite_train":
            mla_train["launches"]["fused_vmm"],
        "launches_mamba2_1_3b": ssm_serve["serve"]["reads"],
        "launches_by_kernel_mamba2_1_3b":
            ssm_serve["serve"]["launches_by_kernel"],
        "launches_mamba2_1_3b_train": ssm_train["launches"]["fused_vmm"],
        "launches_zamba2_1_2b": hybrid_serve["serve"]["reads"],
        "launches_by_kernel_zamba2_1_2b":
            hybrid_serve["serve"]["launches_by_kernel"],
        "launches_zamba2_1_2b_train": hybrid_train["launches"]["fused_vmm"],
        **cross_launches("vmm"),
        "partials_form_24b": sharded_reads(False),
        "bitplane_oracle_25a": bitplane_cases(False),
        "coverage_25b": covered("xbar_fused_vmm"),
        **remat_launches("fused_vmm"),
        **mlp_read_entry(mlp, "vmm", ("l1_vmm", "l2_vmm")),
        **api_entry(api, "vmm")}, {
        "name": "xbar_fused_mvm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xbar_vmm.cu",
        "replaces": "src/repro/kernels/xbar_vmm.py:171",
        "launches": n_mvm,
        "launches_by_kernel": read_kernel_launches(tl, "mvm"),
        "max_abs_err": max(r["max_abs_err"] for r in t_mvm),
        "ms": sum(r["ms"] for r in t_mvm),
        "plain_ms": sum(r["plain_ms"] for r in t_mvm),
        "bound_ms": sum(r["bound_ms"] for r in t_mvm),
        "bound_by": "operations", "library_ms": None,
        "tc_floor_ms": sum(r["tc_floor_ms"] for r in t_mvm),
        "tc_design_ms": sum(r["tc_design_ms"] for r in t_mvm),
        "launches_starcoder2_3b_train":
            dense_train["launches"]["fused_mvm"],
        "launches_llama4_scout_train": moe_train["launches"]["fused_mvm"],
        "launches_deepseek_v2_lite_train":
            mla_train["launches"]["fused_mvm"],
        "launches_mamba2_1_3b_train": ssm_train["launches"]["fused_mvm"],
        "launches_zamba2_1_2b_train": hybrid_train["launches"]["fused_mvm"],
        **cross_launches("mvm"),
        "partials_form_24b": sharded_reads(True),
        "bitplane_oracle_25a": bitplane_cases(True),
        "coverage_25b": covered("xbar_fused_mvm"),
        **remat_launches("fused_mvm"),
        **mlp_read_entry(mlp, "mvm", ("l2_mvm",)),
        **api_entry(api, "mvm")}, {
        "name": "xbar_outer_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xbar_update.cu",
        "replaces": "src/repro/kernels/xbar_update.py:281",
        "instance": "tensor_core (tc_update_kernel<false>, mma.sync "
                    "m16n8k16 bf16)",
        **write_entry(t_upd, total(tl, "update_tc"), hybrid_train),
        "launches_starcoder2_3b_train":
            dense_train["launches"]["update_tc"],
        "launches_llama4_scout_train": moe_train["launches"]["update_tc"],
        "launches_deepseek_v2_lite_train":
            mla_train["launches"]["update_tc"],
        "launches_mamba2_1_3b_train": ssm_train["launches"]["update_tc"],
        "launches_zamba2_1_2b_train": hybrid_train["launches"]["update_tc"],
        **cross_launches("update_tc"),
        "tile_offsets_24a": sharded_writes("outer"),
        "coverage_25b": covered("xbar_outer_update"),
        **remat_launches("update_tc"), **api_entry(api, "outer")},
        {
        "name": "xbar_update_prepare", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xbar_update.cu",
        "replaces": "src/repro/kernels/xbar_update.py:281 (the operands "
                    "_update_kernel stages; pre-pass of the tensor-core "
                    "write)",
        "launches": total(tl, "update_prepare"),
        "launches_starcoder2_3b_train":
            dense_train["launches"]["update_prepare"],
        "launches_llama4_scout_train":
            moe_train["launches"]["update_prepare"],
        "launches_deepseek_v2_lite_train":
            mla_train["launches"]["update_prepare"],
        "launches_mamba2_1_3b_train":
            ssm_train["launches"]["update_prepare"],
        "launches_zamba2_1_2b_train":
            hybrid_train["launches"]["update_prepare"],
        **cross_launches("update_prepare"),
        "max_abs_err": 0.0 if all(r["prepass_ok"] for r in t_upd)
        else None,
        "ms": sum(r["prepass_ms"] for r in t_upd),
        "plain_ms": sum(r["prepass_plain_ms"] for r in t_upd),
        "bound_ms": sum(r["prepass_bound_ms"] for r in t_upd),
        "bound_by": "bytes", "library_ms": None}, {
        "name": "xbar_fakequant_read", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xbar_fakequant.cu",
        "replaces": "src/repro/kernels/xbar_vmm.py:247",
        "launches": fq_serve["launches"]["fakequant"],
        "launches_by_kernel": fq_serve["launches_by_kernel"],
        "launches_prefill": fq_prefill["reads"],
        "launches_by_kernel_prefill": fq_prefill["launches_by_kernel"],
        "launches_qat": sum(step["fakequant_tc_kernel"]
                            for step in qat["launches_per_step"]),
        "launches_llama4_scout": moe_fq["reads"],
        "launches_llama4_scout_expert_stacks": moe_fq["stack_reads"],
        "launches_deepseek_v2_lite": mla_fq["reads"],
        "launches_deepseek_v2_lite_expert_stacks": mla_fq["stack_reads"],
        "launches_deepseek_v2_lite_tensor_core": mla_fq["tensor_core_reads"],
        "launches_mamba2_1_3b": ssm_fq["reads"],
        **cross_launches("fakequant"),
        "launches_cli_qat_per_step": shard_cli["fakequant_reads_per_step"],
        "launches_seq_30": seq_launches(seq_rows, "fakequant"),
        "launches_decode_step_serve_32": {
            f"{r['arch']} {r['layout']}": r["launches_decode_step"][
                "fakequant"] for r in serve_rows if r["mode"] == "fakequant"},
        "lead_dim": [{key: r.get(key) for key in (
            "case", "E", "T", "K", "N", "instance", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "tc_floor_ms")}
            for r in moe_fq_rows if "ms" in r],
        **fq_entry(fq_decode), "library_ms": None,
        "coverage_25b": covered("xbar_fakequant_read"),
        **api_entry(api, "fakequant"),
        "launches_qat_remat_26b": {
            r["remat"]: r["fakequant_launches"]["fakequant_tc_kernel"]
            for r in remat_dry if r.get("case", "").startswith("qat")
            and "remat" in r},
        "instances": [{
            "name": "fp32 (fakequant_scale_kernel, fakequant_fp32_kernel, "
                    "fakequant_epilogue_kernel)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/xbar_fakequant.cu",
            "replaces": "src/repro/kernels/xbar_vmm.py:247 (decode)",
            "launches": fq_serve["launches_by_kernel"]
            ["fakequant_fp32_kernel"],
            **fq_entry(fq_decode), "library_ms": None,
            "threshold": fq_entry(fq_rows_of(fq_rows, K.FQ_TC_MIN_TOKENS,
                                             "fp32")),
            "prefill": fq_entry(fq_rows_of(fq_rows, 2048, "fp32"))}, {
            "name": "tensor_core (fakequant_prepare_kernel, "
                    "fakequant_tc_kernel: mma.sync m16n8k16 bf16, "
                    "fakequant_epilogue_kernel)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/xbar_fakequant.cu",
            "replaces": "src/repro/kernels/xbar_vmm.py:247 (prefill)",
            "launches": fq_prefill["launches_by_kernel"]
            ["fakequant_tc_kernel"],
            **fq_entry(fq_rows_of(fq_rows, 2048, "tensor_core")),
            "library_ms": None,
            "threshold": fq_entry(fq_rows_of(fq_rows, K.FQ_TC_MIN_TOKENS,
                                             "tensor_core")),
            "decode": fq_entry(fq_rows_of(fq_rows, 4, "tensor_core"))}]}, {
        "name": "xbar_fakequant_split", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xbar_fakequant.cu",
        "replaces": "src/repro/kernels/xbar_vmm.py:247 (the fakequant "
                    "read of a column-split leaf under tensor parallelism: "
                    "xbar_fakequant_split + xbar_fakequant_finish, the "
                    "per-token range over the whole width from the ranks' "
                    "gathered range partials)",
        **tp_split_entry(tp_qat),
        "launches_family_29": family_launches(family, "split"),
        "launches_seq_30": seq_launches(seq_rows, "split"),
        **serve_entry(serve_rows, serve_reads, "split")}, {
        "name": "xbar_fakequant_tiles", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xbar_fakequant.cu",
        "replaces": "src/repro/kernels/xbar_vmm.py:247 (the fakequant "
                    "read of a row-split leaf under tensor parallelism: "
                    "xbar_fakequant_split with q copied out, the ranks' "
                    "tiles gathered in tile order, xbar_fakequant_tiles "
                    "the epilogue over every tile)",
        **tp_split_entry(tp_qat, "tiles"),
        "launches_family_29": family_launches(family, "tiles"),
        "launches_seq_30": seq_launches(seq_rows, "tiles"),
        **serve_entry(serve_rows, serve_reads, "tiles")}, {
        "name": "xbar_fakequant_expert_shared_scale", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xbar_fakequant.cu",
        "replaces": "src/repro/kernels/xbar_vmm.py:247 (a data rank's rows "
                    "of an expert-stack read, vmapped over the experts in "
                    "the reference: the lead form with sc_in, each "
                    "expert's DAC scale the max over the data ranks, on the "
                    "whole buffer's instance)",
        **moe_expert_entry(moe_qat)}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": fa_launches,
        "max_abs_err": fa_main["max_abs_err"], "ms": fa_main["ms"],
        "plain_ms": fa_main["plain_ms"], "bound_ms": fa_main["bound_ms"],
        "bound_by": fa_main["bound_by"],
        "library_ms": fa_main["library_ms"],
        "tc_floor_ms": fa_main["tc_floor_ms"],
        "coverage_25b": covered("flash_attention"),
        "bf16": {key: fa_bf16[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms",
            "tc_floor_ms")}}, {
        "name": "xbar_pulse_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xbar_update.cu",
        "replaces": "src/repro/kernels/xbar_update.py:281 "
                    "(update_mode=\"pulse_train\")",
        "instance": "tensor_core (tc_update_kernel<true>, mma.sync "
                    "m16n8k16 bf16, two accumulates)",
        **write_entry(t_pulse, total(carry["launches_per_step"],
                                     "update_tc"), None),
        "tile_offsets_24a": sharded_writes("pulse_train"),
        "coverage_25b": covered("xbar_pulse_update"),
        **api_entry(api, "pulse")}]
    details["tie_recounts"] = TIE_RECOUNTS
    details["kernels_line_note"] = (
        "xbar_fused_vmm: launches counts the serving run's reads (each one "
        "read-kernel launch: on the FP32 instance with its K-order sum, on "
        "the tensor-core instance with its pre-pass and range "
        "pass; launches_by_kernel), launches_train the 4 training steps'; "
        "ms, plain_ms and bound_ms sum one lm100m layer's four reads at "
        "decode (B=4, 64x64 tiles), train_* at training (B=T=2048, FP32 "
        "bound; train_tc_floor_ms the function's tensor-core floor, one "
        "pass of three bf16 parts; train_tc_design_ms the two-pass design's "
        "own cost, not a bound). "
        "xbar_fused_mvm: launches counts the 4 training steps' transpose "
        "reads; ms, plain_ms and bound_ms sum one layer's four transpose "
        "reads at training (B=T=2048; tc_floor_ms and tc_design_ms as "
        "train_tc_*). launches_by_kernel counts each of the read's kernels "
        "as the wrapper counted its launches. xbar_outer_update: the "
        "tensor-core instance; launches counts its launches in the 4 "
        "training steps (phase 7); ms (the whole write, pre-pass included), "
        "plain_ms and bound_ms sum the four containers' (12, K, N) writes "
        "at T=2048 with counter-PRNG noise (phase 6(b)); bound_ms is the "
        "function's floor (tapes read once and G in and out at the HBM "
        "rate, products at the bf16 rate), design_ms the tensor-core "
        "design's own (plus the bf16 code planes written and read), "
        "fp32_bound_ms the bound on the FP32 cores; fp32_instance the same "
        "write on the FP32 instance (run only by phases 6 and 12). "
        "xbar_update_prepare: the tensor-core write's pre-pass (bf16 code "
        "planes), launches in phase 7, ms and plain_ms (its plain twin) at "
        "phase 6(b)'s shapes, max_abs_err 0.0 when bit-equal. "
        "max_abs_err is the largest at those shapes (dynamic ADC "
        "range for the reads). No single PyTorch call computes any of the "
        "three functions, so library_ms is null; torch.bmm of the write's "
        "accumulate alone is given as "
        "accumulate_bmm_ms_not_the_same_function. xbar_fakequant_read: "
        "launches counts the fakequant serving run's reads (phase 9; each "
        "three launches, launches_by_kernel as counted), launches_prefill "
        "the 2048-token forward's (phase 10(b), on the tensor-core "
        "instance); ms, plain_ms, bound_ms (bytes, or the FP32 rate) and "
        "tc_floor_ms (three bf16 products at 989 TFLOP/s) sum one lm100m "
        "layer's four reads (1024-row tiles) at decode (T=4) on the FP32 "
        "instance, its main path; instances lists both instances, each "
        "with the same figures at its own main path's T (fp32: T=4, "
        "tensor_core: T=2048) and the other T beside them (prefill, "
        "decode); prepass_ms, product_ms and epilogue_ms split ms by "
        "kernel. No PyTorch call computes the function, so library_ms is "
        "null; torch.matmul of the product alone is "
        "matmul_ms_not_the_same_function. flash_attention: launches counts "
        "the calls of flash_attention in phase 11 (eight cases); ms, "
        "plain_ms, bound_ms and library_ms (scaled_dot_product_attention) "
        "are lm100m's heads, float32, causal, S=2048; bf16 the same in "
        "bfloat16; tc_floor_ms the tensor-core floor (3xTF32 at 495 "
        "TFLOP/s for float32, bf16 at 989). xbar_pulse_update: the "
        "tensor-core instance; launches counts its launches in phase "
        "13(a)'s 4 training steps; ms, plain_ms, bound_ms, design_ms, "
        "fp32_bound_ms and fp32_instance as for xbar_outer_update, over the "
        "four containers' (12, K, "
        "N) pulse-train writes at T=2048 with counter-PRNG noise (phase "
        "12(b)); no PyTorch call computes the function, so library_ms is "
        "null; torch.bmm of its two accumulates alone is "
        "accumulates_bmm_ms_not_the_same_function. The MLP (phase 14): "
        "launches_mlp counts the reads of phase 14(b)'s six runs of the "
        "paper's protocol (training steps at B=10 on the FP32 instance, "
        "evaluations at B=2000 on the tensor-core one; "
        "launches_by_kernel_mlp by kernel); mlp_b10_ms, mlp_b10_plain_ms "
        "and mlp_b10_bound_ms (bytes at the HBM rate) sum one training "
        "step's B=10 reads in that direction, one per layer: layer 1 "
        "(785x300) and layer 2 (301x10) forward, layer 2 transposed; "
        "1024x1024 tiles, 8-bit DAC/ADC, dynamic range. Phases 15-17: "
        "launches_gemma_2b counts phase 15's first gemma-2b serve's reads "
        "(all on the FP32 instance with its K-order sum; by kernel beside "
        "it), launches_stablelm-3b and launches_granite-20b phase 16's "
        "serves at 2 layers, launches_starcoder2_3b_train the reads, "
        "transpose reads, tensor-core writes and write pre-passes of "
        "phase 16's starcoder2-3b training step, launches_qat the "
        "tensor-core fakequant reads of phase 17's 4 QAT steps. Phase 18 "
        "(llama4-scout-17b-a16e at full width): launches_llama4_scout "
        "counts the reads of 18(a)'s crossbar serve (xbar_fused_vmm: 7 a "
        "layer a call, an expert stack of 16 one read) and of 18(b)'s "
        "fakequant serve (xbar_fakequant_read; "
        "launches_llama4_scout_expert_stacks the expert-stack reads among "
        "them, each one launch of each of the read's three kernels); "
        "launches_llama4_scout_train the launches of 18(c)'s training step "
        "(1 layer); xbar_fakequant_read's lead_dim lists the expert-stack "
        "reads timed in 18(b) (16 experts, K=5120, N=8192, 1024-row "
        "tiles; ms and plain_ms CUDA-event times of the whole read, "
        "bound_ms the bytes or the FP32 rate). Phase 19 "
        "(deepseek-v2-lite-16b at full width): launches_deepseek_v2_lite "
        "counts the reads of 19(a)'s crossbar serve at 4 layers "
        "(xbar_fused_vmm: 9 a layer a call, wkv_b's on the tensor-core "
        "instance, by kernel beside it) and of 19(b)'s fakequant serve "
        "(xbar_fakequant_read; _expert_stacks the expert-stack reads, "
        "_tensor_core the reads on its tensor-core instance: wkv_b at "
        "decode); launches_deepseek_v2_lite_train the launches of 19(c)'s "
        "training step (2 layers). Phases 20-21 (mamba2-1.3b, zamba2-1.2b "
        "at full size, static scheduler): launches_mamba2_1_3b and "
        "launches_zamba2_1_2b count the reads of 20(a) / 21(a)'s crossbar "
        "serves (96 / 106 a model call; the prefill's on the tensor-core "
        "instance, decode's on the FP32 one, by kernel beside them) and, "
        "for xbar_fakequant_read, of 20(b)'s fakequant serve (each one "
        "launch of each FP32-instance kernel); _train the launches of "
        "20(c)'s step at 8 layers and 21(b)'s at 13 (2 shared-block "
        "applications); xbar_outer_update's fp32_instance carries the "
        "shared block's five FP32-instance writes of 21(b) over 2 x 2048 "
        "rows and their device time in its profiled step. Phases 22-23 "
        "(whisper-medium at full size, llama-3.2-vision-90b at full width: "
        "5 of 100 layers from crossbars and in its step, 10 in fakequant "
        "mode; static scheduler with the stream as extras): "
        "launches_whisper_medium and launches_llama_3_2_vision_90b count "
        "the reads of 22(a) / 23(a)'s crossbar serves (xbar_fused_vmm, by "
        "kernel beside them: the prefill's on the tensor-core instance, "
        "whisper's decode reads on the FP32 one, the VLM's cross wqkv over "
        "4 x 1025 rows on the tensor cores every decode call) and of 22(b) "
        "/ 23(b)'s fakequant serves (xbar_fakequant_read; _tensor_core the "
        "reads on its tensor-core instance); _train the launches of 22(c)'s "
        "step at 48 layers and 23(c)'s at 5. Phase 24 (the sharded step's "
        "kernel work, each shard of a layout in turn on this card): "
        "tile_offsets_24a counts the write cases (lm100m's four containers "
        "on 2x4 and 4x4 layouts and one llama4-scout expert stack over 4 "
        "shards, both instances) whose blocks, each written alone at its "
        "offsets, reassemble bit-equal to the whole write; "
        "partials_form_24b the read cases whose shards' partials-form reads, "
        "combined in tile order and summed by reduce_tiles_kernel, are "
        "bit-equal to the whole read, with B{4,2048}_ms the whole reads' "
        "and B{4,2048}_sharded_ms all shards' reads and tile sums on one "
        "card, summed over the four containers and both layouts; "
        "launches_cli_qat_per_step the fakequant reads of each step of "
        "24(c)'s training CLI (torchrun, one NCCL rank, QAT). Phase 25: "
        "bitplane_oracle_25a counts, per instance, the reads (2, 4, 8 and "
        "9-bit DACs, lm100m's four containers and a ragged shape) bit-equal "
        "to the bit-plane oracle kernels.ref.vmm_bitplanes; coverage_25b "
        "lists the launch-coverage cases of analysis.kernel_lint (ragged "
        "and full width, every instance) and counts those with every output "
        "element written, no guard element touched and two launches "
        "bit-equal; those launches are not counted in launches. Phase 26 "
        "(per-layer remat, REPRO_REMAT; phases 1-25 run under none): "
        "launches_lm100m_train_remat_26a counts one lm100m device-mode "
        "step's launches under each policy (the forward reads of full and "
        "dots include the backward's recompute), "
        "launches_starcoder2_3b_train_full_depth_26c the 30-layer "
        "starcoder2-3b step's under full, "
        "launches_zamba2_1_2b_train_remat_26d the 13-layer zamba2-1.2b "
        "step's under none and full; xbar_fakequant_read's "
        "launches_qat_remat_26b the tensor-core fakequant reads of one "
        "lm100m QAT step under each policy. Phase 27 (FSDP and tensor "
        "parallelism; each rank of a layout its own process on this card, "
        "a gloo group whose collectives move through slots on the card "
        "mapped by CUDA IPC): xbar_fakequant_split is kernel 4's "
        "split-range form (the pre-pass and the product, then the "
        "epilogue on every rank's range partials gathered in column "
        "order), xbar_fakequant_tiles its row-split form (the pre-pass "
        "and the product with q copied out, then the epilogue over every "
        "rank's tiles gathered in tile order): launches counts their reads "
        "in 27(a)'s lm100m QAT steps on 2x2, 1x4 and 4x1, summed over the "
        "ranks; ms, plain_ms and bound_ms one such read at 2048 tokens "
        "through 768 x 1152 of wqkv or 1536 x 768 of w_down (rank 0 of "
        "2x2), its gather over the ranks left out; no PyTorch call "
        "computes the function, so library_ms is null. Phase 28 (tensor "
        "and expert parallelism of the MoE family, deepseek-v2-lite cut to "
        f"{MOE_LAYERS} layers at full width, QAT, and llama4-scout's one "
        "layer): xbar_fakequant_expert_shared_scale is kernel 4's lead form "
        "with a given DAC scale per expert (sc_in) on a data rank's rows of "
        "each expert's buffer: launches counts the expert-stack reads of "
        "28(a)'s steps on 2x2, 1x4 and 4x1, summed over the ranks; ms, "
        "plain_ms and bound_ms one such read on rank 0 of 4x1; no PyTorch "
        "call computes the function, so library_ms is null. Phase 29 "
        "(tensor parallelism of the SSM, hybrid and cross-attention "
        "families, QAT at full width: mamba2-1.3b at 2 layers, zamba2-1.2b "
        "at 6, whisper-medium at 2 + 2): xbar_fakequant_split's and "
        "xbar_fakequant_tiles' launches_family_29 count their reads in "
        "29(a)-(c)'s steps on 2x2, 1x4 and 4x1, summed over the ranks, by "
        "model (in_proj with B, C and dt whole on every rank, the shared "
        "block, the cross wqkv over the tokens and the frames). Phase 30 "
        "(REPRO_SEQ_SHARD, deepseek-v2-lite on 2x2 and 1x4, mamba2, "
        "zamba2 and whisper-medium on 1x4, QAT): launches_seq_30 counts "
        "each case's reads in its step, summed over the ranks "
        "(xbar_fakequant_read every read, the chunk reads of wkv_a and the "
        "shared in among them; _split and _tiles their split forms). "
        "Phase 31 (the reference's last entry points at lm100m's "
        "containers): stochastic_round_31a counts the reads (B=4 and "
        "2048; the fakequant read at T=4 and 2048) with "
        "stochastic_round=True bit-equal to the flag off, "
        "ops_bit_equal_31d the kernels.ops reads bit-equal to "
        "core.xbar_ops', lut_bit_equal_31b the kind=\"lut\" writes (both "
        "instances) bit-equal to kind=\"taox\" at the same seed; "
        "ops_outer_update_31c lists kernels.ops.outer_update's CUDA-event "
        "ms per container and noise mode beside the direct "
        "xbar_outer_update of the same quantised operands (direct_ms) and "
        "the quantisation alone (quantise_ms)")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
