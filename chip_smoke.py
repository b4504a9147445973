"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Run from the repo root; needs one CUDA device (Hopper: the kernels build
for sm_90a) and nvcc. It imports nothing of JAX or of the JAX package.
Phases, each printing its own lines:

1. Device: the card's name and power limit (nvidia-smi) and torch's name.
2. Build: nvcc builds every kernel of the serving and training paths from
   the sources, one process per source (gemm_core.cu in six parts), all
   started together.
3. Kernels against their plain PyTorch versions on the card, at the
   full-width shapes of internlm2-1.8b's decode (M = 4, 8 slots) and
   prefill (M = 512): the GEMM core's fake_quant_rhs (bf16 weights),
   dequant (int8) and unpack_dequant (bits 2, 3, 4, 8) epilogues over
   K->N = 2048->2048, 2048->1024, 2048->8192, 8192->2048 and 2048->92672
   (and at M = 4 the widths phase 8's pruning leaves, 2048->5734 and
   5734->2048, in fake_quant_rhs, dequant and unpack_dequant b4, each
   weight stored as `prepare_serving` stores it: rows padded to 16 bytes;
   and at the heights of phase 9's verify pass, M = 12 and 20, on the
   tensor-core variant, in the same three epilogues over every
   projection shape of a verify pass: 2048->8192, 8192->2048,
   2048->92672, 2048->2048 and 2048->1024),
   split-rows flash-decode attention at B = 4, 8 (KVh 8, g 2, dh 128, S
   576, bf16 K/V) and at long context (B = 4, S = 4096, slots spread over
   the arena), and page-indirect flash decode at the same shapes over
   pages of 16 rows in a shuffled order, with bf16, int8 and int4 pages.
   Outputs compare in f32 at rtol 1e-4, atol 1e-4 * max|y| against the
   plain version (a GEMM's second call bitwise its first; a small-M GEMM
   one device kernel per call, counted from a profiler trace) and at rtol
   1e-5, atol 1e-5 * max|y| against the split
   mirror (`ref.decode_attn_split_ref`, the kernel's own algorithm and
   order); on bf16 pages the paged kernel must also equal the contiguous
   kernel on the gathered rows bit for bit. Then the training shapes (T =
   B*S = 2048 tokens):
   the fake-quant forward and backward kernels on the head weight
   (2048 x 92672 bf16), a w_gate slice (2048 x 8192 bf16) and phase 11's
   largest shapes in f32, VGG7's conv5 weight (3 x 3 x 512 x 512) and its
   first activation site (64 x 32 x 32 x 128), at t = 1 and
   t = 0.85 (forward and dx bitwise at both, the three sums within
   1e-5 of the sum of their terms' magnitudes and bitwise on a second
   call, one device kernel per call from a profiler trace); the GEMM's
   no-epilogue variant on x.T @ g (2048 x 2048 -> 8192 and 8192 x 2048 ->
   2048, x.T a view; its bf16 output, dwq's, bitwise its f32 output
   rounded), fake_quant_rhs on g @ fq(w.T) (w.T a view) and on
   the forward at M = 2048, each at t = 1 and t = 0.85 (dx also with
   24-bit quantizers, whose codes need the third bf16 piece), and the
   column mask alone and after fake-quant at M = 2048 and M = 4; and the
   SIMT variant (f32 x and weights) on fake_quant_rhs and no epilogue at
   M = 512 and 2048 over 2048->8192 and 8192->2048, and fake_quant_rhs at
   t = 0.85 at M = 2048 over 2048->8192 (rtol 1e-4, atol 1e-4 * max|y|).
   Last, grok-1's shapes (phase 12's model): the GEMM at M = 4 on
   6144->6144 and 6144->1024 (fake_quant_rhs, dequant) and on the head,
   6144->131072 (dequant: served dense, the head is prequantized and
   multiplied by torch.matmul), and at M = 512 on 6144->6144; decode
   attention at B = 4, S = 576, KVh 8, g 6, dh 128; and the fake-quant
   kernels on the bf16 expert stacks of 12a (2 x 8 x 6144 x 32768,
   3.2e9 elements, past 2^31) and 12d (1 x 8 x 6144 x 32768) at the
   16-bit init, held against the plain versions piece by piece (2^27
   elements a piece: forward and dx bitwise, the sums within 1e-5 of
   `sum_scales`, a second call bitwise); their plain_ms is the plain
   version over the pieces. Then the recurrent mixers' shapes (phase
   13's models, `REC_GEMMS`): rwkv6-3b's at decode (M = 4) on 2560->2560,
   2560->8960, 8960->2560, 2560->64 and 64->2560 (f32 x: decay_w2 takes
   the f32 tanh of the LoRA's first product) in fake_quant_rhs, dequant
   and unpack_dequant b4, its head 2560->65536 in dequant and b4, and
   2560->8960 at M = 512; jamba's 8192->16384, 16384->544, 512->16384 (x
   a strided view, rows 544 apart, as `torch.split` leaves dt_low) and
   16384->8192 at M = 4 and 512 in fake_quant_rhs and dequant; weights
   stored as `prepare_serving` stores them. Then phase 14's shapes
   (`FRONT_GEMMS`, `FRONT_DECODE`): internvl2-26b's 6144->16384,
   16384->6144 and head 6144->92672 at M = 4 in fake_quant_rhs and
   dequant, and 6144->16384 at its prefill height M = 2 x (1024 + 512) on
   the tensor-core variant; decode attention at musicgen's MHA (B 4, S
   576, KVh 32, g 1, dh 64: half of each warp's lanes hold a column) and
   on a 256-row ring at positions 300, 255, 1000 and 256 (past its end:
   the kernel attends over min(pos + 1, S) rows, the whole ring once it
   has wrapped).
   Every GEMM row names its variant: M <= 8 the small-M
   one, M > 8 the tensor-core one for bf16 x, the SIMT one for f32 x; a
   tensor-core row is also timed at both block heights (128 and 256 rows)
   beside the one `gemm_core.tc_block_m` picks. Each case prints the
   kernel's time,
   the plain version's, one PyTorch library call's (timed only; the port
   never calls it; for the paged kernel SDPA over the already gathered
   and decoded rows, since no single PyTorch call reads pages; for the
   GEMMs torch.matmul on the decoded weight; none for the fake-quant,
   whose (d, q_m, t) quantizer no single PyTorch call computes) and the
   bound.
4. Correctness: at full width, the compressed model's one-shot prefill of
   a 32-token prompt (plain attention) against 32 sequential decode steps
   (flash-decode kernel); and the smoke config's engine tokens on the
   card against the CPU run of the plain versions (f32: its prefill
   GEMMs must launch the SIMT variant). Then the long sequences:
   `attention_blockwise` in f32 at the model's attention shapes (S 4096,
   block 512) against `attention_dense` at rtol 1e-5, atol 1e-5; a
   4096-token prompt prefilled through it (24 calls, one per layer), its
   last logits within 2^-5 of the logit range of the same prefill
   through the dense attention (bf16 activations: another summation
   order flips a bf16 rounding now and then) with the same argmax unless
   the top-2 gap is within twice that difference, then served by the
   engine for 8 tokens through graph windows, the first the blockwise
   prefill's argmax; and one loss-and-gradient pass at 1 x 4096 (16-bit
   quantizers, remat), every gradient finite, with its peak memory.
5. The main path: the continuous-batching engine serving internlm2-1.8b
   at full width in bf16 (24 layers, random weights from a seed) on 4
   slots, 8 requests, in the dense fake-quant, compressed int8 and packed
   4-bit modes. `warmup()` captures one CUDA graph per window length
   (1-32 steps) and `run()` decodes by replaying them. Each engine drains
   the requests three times: once for its stats, once (the first 4
   requests, 24 tokens each) under a profiler trace, and once through
   eager `step()`; the three must emit the same tokens, and no graph may
   be captured during a drain. The wrapper
   launch counts are zeroed right before and read right after; they count
   host calls, so a graph's calls count once, at capture: every kernel
   of the path must have counted, the GEMM's small-M variant (decode) and
   tensor-core variant (prefill) among them. From the trace, the device
   kernels must equal the eager calls of the drain (its prefills) plus
   each replayed window's captured calls: every small-M GEMM, the small-M
   GEMM of each epilogue (its first template argument), and the
   decode-attention split and combine kernels; every captured GEMM is a
   small-M one. Packed tokens must equal those of an int8 run with the
   same 4-bit quantizer init. Prints each engine's capture time, graph
   pool and peak memory.
6. The paged main path: the same engine and requests from the paged KV
   arena (pages of 16 rows), drained the same three ways with the same
   checks. With bf16 pages its tokens must equal phase 5's in each weight
   mode; packed 4-bit weights with int8 and with int4 pages must serve
   full-length outputs with the bf16 run's first tokens from a smaller
   pool; with 4 of the 8 requests on one prompt, prefix sharing must hit
   at least 3 times and leave the tokens of a run without sharing
   unchanged. The page-indirect split kernel must run 24 times (once per
   layer) per decode step of the traced drain, in every page storage of
   the path.
7. Training, the main path of GETA: `train_loop` on internlm2-1.8b at
   full width in bf16 (random weights from seed 0), batch 4 x 512
   tokens, target sparsity 0.3, with the schedule compressed so that
   every stage runs in 5 steps (warm-up 1, projection 1 x 1, pruning
   2 x 1, cool-down 1), under torch.use_deterministic_algorithms.
   Checks: finite losses, stages 0, 1, 2, 2, 3, every site's bits in
   [b_l, b_u_final], hard sparsity of exactly k_units / total_units,
   pruned units exactly 0, and the launch counts of every kernel of the
   path at their predicted values (counted from 0 over `train_loop`),
   every GEMM on the tensor-core variant (`gemm_core.tc` counts them all,
   `gemm_core.simt` stays 0).
   Then, counted from 0 on their own, one loss-and-gradient step with
   `.colmask` params (seeded random masks keeping about 70% of the
   output columns of wq, wk, wv, w_gate, w_up), with quantizers and
   without: each loss must equal bit for bit the loss of the params with
   those columns zeroed (with quantizers through fake_quant_rhs, without
   through col_mask under an all-ones mask), the masks must move the
   loss, and the plain loss must lie within 1e-3 relative of the
   torch.matmul path's; the col_mask rows of the kernel line take their
   launches from this step. Then two runs of a joint step from one
   state, which must give the same params, quantizers and masks bit for
   bit; and the smoke config's joint step on the card against its CPU
   run at `train.STEP_TOLERANCES` (its GEMMs on the SIMT variant), and
   the same step with activation quantizers (masks identical and the loss
   within tolerance held; params and quantizers reported, since a rounding
   tie of an activation flipped by the summation order moves them past
   it). Prints step wall times, tokens/s and peak device memory.
8. Pruned serving at full width: the engine of phase 5 on the subnet at
   magnitude masks of sparsity 0.3 (d_ff 8192 -> 5734 in every layer, 6
   of the 8 KV-head groups: 12 heads), phase 5's 8 requests, in the
   three weight modes over the contiguous arena, each drained the same
   three ways with phase 5's checks (graph windows equal eager steps and
   a traced drain; the trace's small-M kernels equal the host counts),
   the launch counts zeroed before the three engines and read after.
   Against phase 5, per mode: param_bytes, decode tok/s, and the block
   projections' bytes, which must equal the bytes the sliced widths
   predict (the heads fall by 2/8, the MLP units by 2458/8192: the units'
   sparsity is 0.3, the bytes' ~0.29); kv_bytes exactly 6/8 of phase 5's.
   Packed 4-bit tokens must equal an int8 run's at the same 4-bit init;
   packed 4-bit over bf16 pages the contiguous run's tokens, over int8
   pages full-length outputs with its first tokens from a smaller pool.
   Against the masked reference engine (the dense model with the pruned
   units multiplied by zero, same seed and quantizers): the first decode
   step's logits within 2^-5 of the logit range with the same argmax
   (bf16 sums over K 5734 and the masked 8192 split differently, so only
   the f32 smoke config is held to token identity; its card tests do),
   greedy-token agreement and first divergences printed. Then GETA's
   train-then-deploy path: phase 7's final params, quantizers and QASSO
   keep masks (exactly k_units pruned) through `construct_subnet`
   (sparsity, mean bits, code bytes printed), then `prepare_serving(
   keep_masks=..., compressed=True)` serves one request of 16 tokens
   through the engine, held to its masked reference the same way.
9. Speculative decoding and chunked prefill at full width (bf16, 4
   slots, phase 5's 8 requests). The pair `build_checkpoint_engines`
   builds: the magnitude-masked checkpoint at sparsity 0.5 as the target,
   served dense fake-quant b8 and as int8 codes, its s50 packed subnet as
   the draft, faithful (b8) and aggressive (b2), draft_k 4. Per engine:
   the first round's verify logits (by hand, then rolled back) against
   the plain engine's first decode step (within 2^-5 of the range, the
   same argmax unless the top-2 gap is within twice the difference);
   `warmup()` captures one graph per draft length of `_spec_ks()`; a
   drain of graph rounds (the measurement); then the first 4 requests
   (6 tokens each) three times, in graph rounds, in eager rounds with
   the rollback invariant after every round (both arenas' rows at and
   past each active slot's position zero) and in graph rounds under a
   profiler trace, equal tokens, the trace's small-M and tensor-core
   GEMMs and decode-attention kernels equal to the replayed graphs'
   captured calls plus the drain's eager ones; no capture in any drain;
   the k = 2 and 4 graphs (verify M = 12, 20) hold tensor-core GEMMs and
   replay. Printed: decode tok/s
   (committed tokens over round time), ms per round by k, acceptance
   (faithful must exceed aggressive), capture time, graph pool, kv_bytes
   of both arenas, peak memory, token agreement with the plain engine
   (graph windows) and first divergences (bf16: the verify pass sums in
   other tiles than the decode step, so token identity is held in f32,
   by the card tests). The faithful dense pair over bf16 pages must emit
   the contiguous pair's tokens, over int8 pages full-length outputs with
   its first tokens. Chunked prefill (chunk 128: 96 -> 64 + 32, 200 ->
   128 + 64 + 8) on the dense and packed 4-bit engines, contiguous and
   paged: the first token's logits of a chunked prefill against the
   one-shot prefill's (same rule), tokens against phase 5's one-shot
   engines (agreement printed), prefill tok/s against phase 5's, the
   one-step decode graph captured in `warmup()`; then the longest gap
   between two decode steps of a slot while a 512-token prompt is
   prefilled, chunked and one-shot, three runs each. The launch counts
   are zeroed before the phase and read after it.
10. The checkpointed, fault-tolerant run loop: `train_loop` on
   internlm2-1.8b at full width (d_model 2048, d_ff 8192, vocab 92544)
   with its depth cut to 4 of 24 layers (a checkpoint of the whole
   model, ~19 GB with AdamW's f32 moments, would take most of the
   phase to write), bf16, batch 4 x 512, 8 steps (warm-up 1, projection
   1 x 1, pruning 2 x 2, cool-down 2) under
   torch.use_deterministic_algorithms: once uninterrupted, once with a
   checkpoint every 5 steps and a failure injected at step 7, which
   restores step 5 and replays 5-7 across the joint stage's end. The
   final trees must be equal bit for bit (every leaf: params, quantizers,
   the QASSO state with its Python-int counters, the data key), the
   killed run's 10 losses the clean run's at each step, one restart, the
   stages in order, and each run's launch counts at
   `predicted_train_launches`. Prints the checkpoint's bytes, the save
   and restore seconds, the step walls past step 5 and peak memory; the
   checkpoint directory is removed.
11. The paper's substrates at the JAX package's full specs: VGG7 (widths
   128-512, fc 1024) with weight and activation quantizers (Table 4) and
   ResNet20 with weight quantizers (Table 2), each on batches of 64
   32 x 32 images (`image_batch`, NHWC), and the BERT encoder at its
   defaults (4 layers, d_model 256, 4 heads, d_ff 1024, vocab 8192) on
   `qa_batch` at 16 x 64 (Table 3's harness), each through 6 GETA steps
   (every stage) under torch.use_deterministic_algorithms. Checks: finite
   losses, stages in order, every site's bits in [b_l, b_u_final],
   exactly k_units pruned units, all zero, two runs of the first joint
   step from one state bitwise equal, the fake-quant launches at
   `predicted_substrate_launches` (each weight and activation site once
   forward and once backward a step, each weight once more in a joint
   step) and no GEMM kernel (convolutions and products are plain
   PyTorch, as they are plain XLA in the JAX package). Then
   `construct_subnet` and `model_bops` on the trained state; prints
   sparsity, mean bits, rel_bops, step walls, images or tokens per
   second and peak memory.
12. The MoE family at grok-1's published widths (d_model 6144, 48 heads
   / 8 KV, d_head 128, 8 experts top-2, d_ff 32768, vocab 131072, bf16,
   random weights from seed 0), depth cut to 2 of 64 layers; the
   reckoned bytes (params, the engine's fake-quanted copy of the expert
   stacks and the head, KV a token) are printed before anything is
   built. 12a: phase 5's traffic through the engine in the dense
   fake-quant and int8 modes over the contiguous and paged arenas, each
   through graph windows and then eager steps (tokens bitwise equal);
   paged tokens equal contiguous tokens; the expert stacks stay dense
   with their fake-quant sites in int8 mode; a 32-token prompt's
   full-capacity prefill against 32 eager decode steps (last logits
   within 2^-5 of the range, the same argmax unless the top-2 gap is
   within twice the difference); a traced 16-step window gives the step
   wall, busy time, idle share and the library (cuBLAS) products' device
   ms a step against their byte bound. 12b: pruned at sparsity 0.5 with
   the expert floor (8 -> 4 experts, at least top_k): the slim plan's
   experts, expert bytes exactly kept / 8 of the dense stacks, kv_bytes
   at the surviving KV heads, graph tokens equal eager tokens. 12c: a
   dense target with its s50 b8 MoE draft, k 4: graph rounds equal eager
   rounds, the rollback invariant after every eager round, acceptance
   and ms per round (at 1 layer if the reckoned peak passes 70 GB). 12d:
   one `loss_and_grads` at 1 layer (widths full), batch 2 x 256, 16-bit
   init: finite loss and gradients, each expert site's backward against
   the plain version (dx bitwise, sums within 1e-5 of `sum_scales`), the
   launches at `predicted_moe_grad_launches`. Prints peak memory; the
   launch counts are zeroed before 12a and read after 12c.
13. The recurrent mixers, random weights from seed 0, bf16, 4 slots,
   phase 5's traffic at lengths the recurrent prefill takes (64, 128,
   256, 512, 192, 320, 32 and 384 tokens, 64 generated each); the
   reckoned bytes are printed before anything is built. 13a: rwkv6-3b
   at its published widths (d_model 2560, 40 heads of 64, d_ff 8960,
   vocab 65536, decay LoRA 64) cut to 8 of 32 layers (`REC_LAYERS`: the
   script's time limit) through the engine in the dense fake-quant, int8
   and packed b4 modes over the contiguous arena, and dense also over the
   paged one (without prefix sharing, which recurrent plans refuse), each
   warmed up before its requests are queued (graphs only: a recurrent
   prefill has nothing to set up) and drained through graph windows,
   then eagerly (the 4 requests with the shortest prompts, 16 tokens
   each: tokens bitwise the graph drain's); paged tokens equal contiguous
   tokens; in the dense contiguous engine requests 4 and 7, admitted into
   slots that served other requests, equal their solo drains, and a
   64-token prompt's prefill against 64 eager decode steps: in bf16 by
   `_logits_held` or, where that fails, within the prefill's own spread
   when every embedding weight moves by one bf16 ulp (a random-weight
   rwkv6 moves its logits by half their range then), and a 32-token
   prompt on an f32 copy of the weights by `_logits_held`; the states'
   largest relative gap printed; a traced 16-step window in
   the dense and int8 modes (step wall, busy, idle share, the small-M
   GEMMs' ms against their weights' byte bound, the glue kernels' count
   and ms), decode and prefill tok/s, param and kv bytes, peak memory.
   13b: rwkv6 pruned at sparsity 0.3 (40 -> 28 heads, d_ff 8960 ->
   6272): the plan's widths, wkv leaves at 28 heads, kv_bytes exactly the
   reckoned state, param bytes as the sliced widths predict, graph
   tokens equal eager tokens. 13c: `train_loop` on rwkv6-3b at full width
   and 8 layers, batch 4 x 512, 5 steps through every stage under
   torch.use_deterministic_algorithms (the reckoned peak printed first;
   past 70 GB the batch would be halved): phase 7's checks, the launches
   at `predicted_train_launches` (decay_w2's GEMMs on the SIMT variant),
   two runs of a joint step bitwise equal. 13d: jamba-1.5-large at its
   published widths (d_model 8192, 64 / 8 heads, d_head 128, mamba
   d_state 16, d_conv 4, expand 2, dt_rank 512, d_ff 24576, vocab 65536),
   cut to one period of 8 of 72 layers (1 attention, 7 mamba; 4 MLP, 4
   MoE) and to 4 of 16 experts (top-2): the dense and int8 engines as in
   13a (dense also paged; the prefill check in bf16 only), a traced
   dense window (the glue's ms beside the
   GEMMs', the library products' ms against their byte bound), then int8
   pruned at 0.3 (mamba Di 16384 -> 11469) over the contiguous arena. The
   launch counts are zeroed before 13a and read after 13d, where every
   kernel of the path must have launched; the GEMM launches are tallied
   by (variant, epilogue, K, N) for the kernel line.
14. The last LM families at published widths, bf16, random weights from
   seed 0; the reckoned bytes, peak and predicted times are printed
   before each sub-phase. 14a: musicgen-large at its published widths
   (d_model 2048, 32 MHA heads of 64, d_ff 8192, 4 codebooks of vocab
   2048) cut to 24 of 48 layers (`AUDIO_LAYERS`: whole, 3.26e9 params,
   until PR 26, when the script passed 1100 s on a slow host; the cut
   drops half the eager `serve_loop`'s layers, not a check) through
   `serve_loop` (the static loop, which
   codebook archs serve through) at batch 4, 64 prompt frames and 64
   generated, in the dense fake-quant, int8 and packed b4 modes, and int8
   at the 4-bit init, whose frames the packed ones must equal; a 32-frame
   one-shot prefill against 32 sequential decode steps (`_logits_held`,
   per codebook); one int8 decode step under a profiler trace: exactly 7
   small-M GEMM kernels a layer plus the head's, and a split and a
   combine decode-attention kernel a layer; `construct_subnet` at
   magnitude masks of sparsity 0.3, then `serve_loop` pruned (int8) at
   that sparsity, whose param_bytes must equal the bytes the sliced widths
   predict (`lm_reckoning`), with its frames/s. 14b: `train_loop` on
   musicgen-large, 4 x 512 frames, 5 steps through every stage, at whole
   depth while the reckoned peak stays within 72 GB (else the deepest cut
   that fits, printed): stages, exactly k_units pruned, finite losses,
   the launches at `predicted_train_launches`, step wall, frames/s and
   peak. 14c: internvl2-26b at its published widths (d_model 6144, 48 / 8
   heads of 128, d_ff 16384, vocab 92553 padded to 92672, 1024 patches)
   cut to 8 of 48 layers: `prefill(vision_embeds=)` of 2 x (1024 patches
   + 512 text) (the GEMMs at M = 3072 on tensor cores), 32 decode steps,
   the last logits against `forward` over all 1568 positions
   (`_logits_held`); `serve_loop` text-only (prompt_len 1088: 64 text
   tokens, as the reference slices them) dense and int8; one GETA step
   (joint stage) at 2 of 48 layers on a 2 x (1024 + 512) batch, every
   gradient finite, peak printed. 14d: internlm2-1.8b at its published
   widths cut to 12 of 24 layers (`WINDOW_LAYERS`, PR 26, the same
   reason) with the JAX package's `window` field set to 256 (no config
   of the repo sets one):
   the engine on 4 slots, prompts of 32-256 tokens each generating until
   it has decoded past row 255 of its ring, through graph windows, then
   eager `step()` (tokens equal), kv_bytes exactly 4 slots x 256 rows;
   the longest request's last decode logits, past the wrap, against the
   windowed `forward` over its whole sequence (`_logits_held`); the paged
   arena, speculative decoding, chunked prefill and a 300-token prompt
   each refused with a ValueError. The launch counts are zeroed before
   14a and read after 14d, where every kernel of the path must have
   launched; the GEMM launches are tallied by (variant, epilogue, K, N).
   Then, on the smoke configs in f32 with one CPU-drawn model: musicgen's
   `serve_loop` frames, the window-8 engine's tokens past the wrap and
   internvl2's vision prefill + decode tokens on the card equal the CPU
   run of the plain versions.
15. Tensor parallelism and the sharded GETA step, on 4 rank processes
   that share the card (a `launch.mesh.RankPool`, started after phase 2
   built the library: gloo with every collective staged through host
   memory, since NCCL refuses two ranks on one device), at tp 2 and 4.
   Phase 3 adds a row for every local call a rank of 15b's engines
   makes (`TP_GEMMS`: each projection's column or K tile at tp 2 and 4,
   at M = 4 and 512, in fake_quant_rhs and dequant; the head's vocab tile
   from codes; decode attention, contiguous and on bf16 pages, on a
   rank's 8 / tp KV heads), each held against its plain version and
   timed there; 15b fails if a rank launched a GEMM at a (variant,
   epilogue, K, N) that has no such row.
   15a: on the ranks, `tp_gemm` at the full decode shapes (w_gate in
   fake_quant_rhs and dequant, the head in dequant) and `tp_decode_attn`
   bitwise the 1-rank call on every rank (each column tile plans its K
   split as the full-width call), and w_down split on K with its partials
   summed in rank order within 1e-4 of max|y|. 15b: internlm2-1.8b at its
   published width (bf16, seed 0, every rank drawing the same weights) on
   4 slots, phases 5-6's 8 requests, in the dense fake-quant and int8
   modes over both arenas at tp 2 and 4 (8 engines), `TP_GEN` tokens a
   request (cut from phases 5-6's 64: ROADMAP item 14b): every rank's
   tokens equal; the
   first decode step's logits against a 1-rank engine's (`_logits_held`,
   contiguous), token agreement against phase 5's 1-rank tokens printed;
   a rank's KV pool exactly 1/tp, per-rank param bytes, decode tok/s and
   step ms beside the transport and the decode mode (eager: a gloo
   collective cannot be captured); then the smoke config (f32) at tp 4
   on the card against the CPU run's tokens. 15c: internlm2-1.8b at full
   width cut to phase 10's 4 layers, batch 4 x 512, 3 steps (warm-up,
   projection, a joint step that partitions), on 2 ranks in DP and FSDP:
   losses, params, quantizers and masks (digests) bitwise the 1-rank
   step's with grad_slices=2, the reckoned memory, step walls and peak a
   rank printed. The ranks' launch counts are zeroed before each drive
   and read after; every kernel of the path must have launched.
16. The paper's experiment runners and the dry run
   (`launch.experiments`, `launch.dryrun`). 16a: the runners at the JAX
   package's full specs, each cut to steps=12 (11 QASSO steps through
   every stage, against the reference's 120-240; the paper-scale
   accuracies are the CLI's, `python -m repro_torch.launch.experiments
   --spec full`): `run_baseline_cnn` and `run_geta_cnn` on ResNet20
   (weight quantizers) and on VGG7 (the GETA run with activation
   quantizers), `run_geta_cnn` on ResNet56 at sparsity 0.4, and
   `run_geta_bert` and `run_prune_then_ptq_bert` at `BertEncoder()`'s
   defaults at sparsity 0.3. Checks: finite losses, the stages in order,
   exactly k_units units pruned and their elements zero, bits within
   [b_l, b_u_final] and rel_bops < 1 in every GETA run, the fake-quant
   launches at `predicted_runner_launches` (phase 11's count plus the
   evaluation's forward) and no GEMM kernel. Prints accuracy or exact
   match, rel_bops, sparsity, mean bits, the median step wall and images
   or tokens a second. 16b: the meta dry run against the card on
   internlm2-1.8b at phase 10's 4 of 24 layers (widths full, 1 x 1 mesh):
   one GETA joint-stage step at batch 4 x 512 and one eager decode step
   over phase 5's 4 slots and 576-row arena. The meta launch record by
   (variant, epilogue, K, N), by fake-quant input shape and decode
   attention must equal what the card launched for the same step (the
   wrappers' counts, tallied by shape), and the dry run's arg bytes the
   card tensors' bytes. Printed, not gated: the meta FLOPs over the
   card's measured wall (TFLOP/s and its share of 989e12) and the meta
   peak estimate (args + temp) against `max_memory_allocated`. Prints
   the phase's and the script's seconds.
17. Two JSON lines: the kernel table, then the device line (last). A
   serving kernel's `launches` are the host counts of phases 5-6 (a
   graph's calls once, at capture), a pruned-shape GEMM row's those of
   phase 8, a verify-height row's those of phase 9 (the captures of its
   draft length's graphs, with `replayed_launches` the replays' kernels),
   the fake-quant rows at phase 11's shapes those of phase 11, the rows
   at grok-1's shapes those of phase 12 at their shape, the rows at the
   recurrent shapes those of phase 13 at their shape, the rows at phase
   14's shapes those of phase 14 (decode attention's: 14a's at musicgen's
   shape, 14d's on the ring), the rows at a tp rank's local shapes those
   of 15b's engines at the row's (variant, epilogue, K, N), or its tp and
   arena for decode attention, summed over the ranks;
   `traced_device_launches` are its device kernels in their traced
   drains (for a GEMM epilogue the small-M kernels, for decode attention
   the split kernels).

Each phase prints its seconds.

Times are CUDA-event medians with the 50 MB L2 flushed before each launch
(each decode-step launch finds its weights cold); after the flush the
device sleeps ~0.1 ms, so the host has enqueued the call before the start
event fires and the interval holds device time only. Bounds: the larger of
the bytes the call must move over 3.35 TB/s and its operations over
989 TFLOP/s (H100 SXM datasheet: HBM3 and dense bf16 tensor-core peaks).
TF32 is off for every PyTorch matmul here, so plain versions and library
calls run in full f32 (the kernels never use TF32). `--out PATH` also
writes every kernel row and the launch counts to PATH as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12      # f32 FMAs outside the tensor cores
ARCH = "internlm2-1.8b"
GEMM_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
               (2048, 92672)]
GEMM_MS = [4, 8, 512]
PROMPT_LENS = [64, 128, 256, 512, 96, 200, 32, 384]
GEN = 64
SLOTS = 4
TRACE_GEN = 24            # tokens per request of phases 5-6's traced drains
TRACE_WARMUP = 64         # fill kernels that open each traced drain
PAGE = 16
SHARED = (1, 3, 5, 7)     # requests that carry request 5's prompt (200
                          # tokens: 12 full pages and a shared tail page)
PAGED_KERNELS = ("paged_decode_attn.bf16", "paged_decode_attn.int8",
                 "paged_decode_attn.int4")
REPORT_SHAPE = (4, 2048, 8192)      # the JSON line's GEMM row: w_gate at decode
PRUNE_SPARSITY = 0.3       # phase 8: d_ff 8192 -> 5734, 8 -> 6 KV heads
# phase 3's rows at those widths (M = 4): w_gate / w_up, then w_down
PRUNED_GEMMS = [(2048, 5734), (5734, 2048)]
PRUNED_EPIS = ("fake_quant_rhs", "dequant", "unpack_dequant_b4")
GETA_GEN = 16              # phase 8's request from phase 7's trained masks
# phase 3's rows at phase 9's verify heights (4 slots x (k + 1), k = 2, 4)
VERIFY_MS = [12, 20]
# every projection shape of a verify pass: w_gate / w_up, w_down, the head,
# wq / wo and wk / wv
VERIFY_SHAPES = [(2048, 8192), (8192, 2048), (2048, 92672), (2048, 2048),
                 (2048, 1024)]
# phase 8: the pruned engine's first decode-step logits against the masked
# reference's, in units of the reference's logit range: phase 4's bound for
# bf16 activations summed in another order (here K = 5734 against the
# masked K = 8192, split differently)
MASKED_TOL = 2 ** -5
TOKENS = 2048                        # training batch 4 x 512
TRAIN_BATCH, TRAIN_SEQ = 4, 512
FQ_SHAPES = {"head": (2048, 92672), "w_gate": (2048, 8192)}
# phase 11's largest fake-quant shapes, f32: VGG7's largest conv weight
# (conv5, HWIO) and its first activation site (relu0 at batch 64, NHWC)
CNN_FQ_SHAPES = {"vgg7_conv": (3, 3, 512, 512), "vgg7_act": (64, 32, 32, 128)}
# (label, M, K, N, layout, t, bits) of the training GEMMs, each in the
# layout the train step hands it: x.T @ g (dwq, x.T a view), g @ fq(w.T)
# (dx, w.T a view) and the forward, for w_gate (2048 -> 8192) and w_down
# (8192 -> 2048); fake-quant at t = 1 (every quantizer's init) and at
# t = 0.85 (once QASSO moves t: a powf per decoded weight), at 8 bits and
# at 24 (codes of more than 16 significant bits, as warm-up's quantizers
# reach: the third bf16 piece)
TRAIN_GEMMS = [("none", 2048, 2048, 8192, "x.T,w", 1.0, 8),
               ("none", 8192, 2048, 2048, "x.T,w", 1.0, 8),
               ("fake_quant_rhs", 2048, 8192, 2048, "x,w.T", 1.0, 8),
               ("fake_quant_rhs", 2048, 8192, 2048, "x,w.T", 0.85, 8),
               ("fake_quant_rhs", 2048, 8192, 2048, "x,w.T", 1.0, 24),
               ("fake_quant_rhs", 2048, 8192, 2048, "x,w.T", 0.85, 24),
               ("fake_quant_rhs", 2048, 2048, 8192, "x,w", 1.0, 8),
               ("fake_quant_rhs", 2048, 2048, 8192, "x,w", 0.85, 8),
               ("col_mask", 2048, 2048, 8192, "x,w", 1.0, 8),
               ("col_mask", 4, 2048, 8192, "x,w", 1.0, 8),
               ("fq_col_mask", 2048, 2048, 8192, "x,w", 1.0, 8),
               ("fq_col_mask", 4, 2048, 8192, "x,w", 1.0, 8)]
# the JSON line's rows of the training kernels (all on the tensor-core
# variant but the fake-quant kernels); the fake_quant_rhs row also carries
# its t = 0.85 time (`at_t0.85`), one kernel and one launch count
TRAIN_REPORT = {"gemm_core.tc.none": TRAIN_GEMMS[0],
                "gemm_core.tc.fake_quant_rhs": TRAIN_GEMMS[2],
                "gemm_core.tc.col_mask": TRAIN_GEMMS[8],
                "gemm_core.tc.fq_col_mask": TRAIN_GEMMS[10],
                "fake_quant.fwd": ("head", 1.0),
                "fake_quant.bwd": ("w_gate", 1.0)}
AT_T085 = TRAIN_GEMMS[3]
# (label, M, K, N, t) of the SIMT variant's rows: f32 x and f32 weights,
# the f32 configuration's operands, at the model's prefill and training
# rows, and fake-quant once at t = 0.85 (a powf per decoded weight)
SIMT_GEMMS = [(label, M, K, N, 1.0) for label in ("fake_quant_rhs", "none")
              for M in (512, 2048) for K, N in ((2048, 8192), (8192, 2048))
              ] + [("fake_quant_rhs", 2048, 2048, 8192, 0.85)]
SIMT_REPORT = ("fake_quant_rhs", 2048, 2048, 8192, 1.0)
TC_HEIGHTS = (128, 256)      # the tensor-core variant's block heights
DECODE_S = 576                # phase 3's decode arena: prompt 512 + 64
LONG_S = 4096                 # and its long-context arena
DECODE_POS = [DECODE_S - 1, 0, 300, 63, 64, 575, 17, 200]
LONG_POS = [LONG_S - 1, 1000, 2500, 63]
SLEEP_CYCLES = 200_000        # ~0.1 ms of device sleep before each timing
DECODE_KERNELS = "flash_decode"   # in the decode-attention kernels' names
ROWS_PER_SPLIT = (32, 64, 128)   # the decode kernels' R, timed at B = 4


def bound_ms(nbytes: int, flops: int,
             flop_per_s: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each call.
    After the flush the device sleeps `sleep_cycles` (0: not at all), so
    that the host has enqueued the call before its start event runs."""

    def __init__(self, torch, sleep_cycles: int = SLEEP_CYCLES):
        self.torch = torch
        self.sleep_cycles = sleep_cycles
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")     # 256 MB > 50 MB L2

    def __call__(self, fn, target_ms: float = 40.0) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t0) * 1e3
        iters = int(min(20, max(3, target_ms / max(once, 1e-3))))
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            self.flush.zero_()
            if self.sleep_cycles:
                torch.cuda._sleep(self.sleep_cycles)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def _height_ms(timer, gc, fn, M, N) -> dict:
    """The tensor-core call `fn` timed at each block height, `rule` the
    height `gc.tc_block_m` picks for it."""
    from repro_torch.kernels import build
    rule = gc.tc_block_m
    out = {"rule": rule(M, N, build.sm_count(0))}
    try:
        for bm in TC_HEIGHTS:
            gc.tc_block_m = lambda M, N, sm, bm=bm: bm
            out[bm] = timer(fn)
    finally:
        gc.tc_block_m = rule
    return out


def _heights(row) -> str:
    h = row.get("heights")
    return "" if h is None else (
        f" bm={h['rule']} (" + ", ".join(f"{bm}: {h[bm]:.4f}"
                                          for bm in TC_HEIGHTS) + " ms)")


def _one_kernel(torch, row, call) -> None:
    """A small-M GEMM or fake-quant row's device kernels per call, from a
    profiler trace after its timings; anything but one clears row["ok"]."""
    if row.get("variant") == "small_m" or row["kernel"].startswith("fake_"):
        row["kernels_per_call"] = _kernels_per_call(torch, call, "")
        row["ok"] = row["ok"] and row["kernels_per_call"] == 1


def _per_call(row) -> str:
    n = row.get("kernels_per_call")
    return "" if n is None else f" kernels/call {n}"


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] nvidia-smi: {line} | torch: {kind}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return kind


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    jobs = sum(len(build.PARTS.get(s.name, ((),))) for s in build._sources())
    print(f"[2 build] nvcc built {len(build._sources())} kernel sources "
          f"(sm_90a) in {jobs} parallel processes in "
          f"{time.perf_counter() - t0:.2f} s")


def _gemm_cases(torch, K, N, gen):
    """(label, weight tensor, epilogue, dequantized bf16 weight) per
    epilogue, from one random bf16 weight with quantizers at their init."""
    from repro_torch.core.quant import (init_quant_params, pack_codes,
                                        quantize_int)
    from repro_torch.kernels import gemm_core as gc
    w = torch.randn((K, N), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * K ** -0.5
    qp = init_quant_params(w, bits=8.0)
    yield ("fake_quant_rhs", w, gc.fake_quant_rhs(qp.d, qp.q_m, qp.t),
           lambda: gc.ref.fake_quant_weight(w.float(), qp.d, qp.q_m,
                                            qp.t).to(torch.bfloat16))
    codes, d = quantize_int(w, qp, bits=8.0)
    c8 = codes.to(torch.int8)
    yield ("dequant", c8, gc.dequant(d),
           lambda: (c8.float() * d).to(torch.bfloat16))
    del codes
    for bits in (2, 3, 4, 8):
        qb = init_quant_params(w, bits=float(bits))
        cb, db = quantize_int(w, qb, bits=float(bits))
        words = pack_codes(cb, bits, axis=0)
        yield (f"unpack_dequant_b{bits}", words, gc.unpack_dequant(bits, db),
               lambda cb=cb, db=db: (cb * db).to(torch.bfloat16))


def _report_name(label: str) -> str:
    """The kernel line's name of a GEMM epilogue row."""
    return ("gemm_core.unpack_dequant" if label.startswith("unpack") else
            f"gemm_core.{label}")


def _gemm_row(torch, timer, gc, label, x, w, epi, w_lib, tag="") -> dict:
    """One GEMM row of phase 3: the kernel against its plain version (a
    second call bitwise the first), its time, the plain version's, the
    library call's (torch.matmul on the decoded weight) and the bound;
    the tensor-core rows at both block heights, the small-M rows' kernels
    per call from a profiler trace."""
    (M, K), N = x.shape, w.shape[1]
    call = lambda: gc.gemm(x, w, epi, out_dtype=torch.float32)
    y, again = call(), call()
    want = gc.plain(x, w, epi, torch.float32)
    torch.cuda.synchronize()
    err = (y - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    ok = bool(torch.allclose(y, want, rtol=1e-4, atol=tol)
              and torch.isfinite(y).all() and torch.equal(y, again))
    row = {"kernel": f"gemm_core.{label}", "M": M, "K": K, "N": N,
           "variant": gc.variant(M, x.dtype), "max_abs_err": err,
           "atol": tol, "ok": ok}
    del y, again, want
    row["ms"] = timer(call)
    row["plain_ms"] = timer(lambda: gc.plain(x, w, epi, torch.float32))
    # an f32 x (rwkv6's decay_w2 input) multiplies the decoded weight in f32
    row["library_ms"] = timer(lambda: torch.matmul(x, w_lib.to(x.dtype)))
    row["bound_ms"], row["bound_by"] = bound_ms(
        gc.bytes_moved(M, N, K, x.element_size(), w, 4, epi),
        gc.flops(M, N, K), BF16_FLOP_PER_S if x.dtype == torch.bfloat16
        else F32_FLOP_PER_S)
    if row["variant"] == "tc":
        row["heights"] = _height_ms(timer, gc, call, M, N)
    _one_kernel(torch, row, call)
    print(f"[3 kernels] {row['kernel']:<29} M={M:<3} K={K:<4} "
          f"N={N:<5} {row['variant']}{tag} ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} "
          f"library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
          f"err={err:.2e} tol={tol:.2e}{_heights(row)}"
          f"{_per_call(row)} {'ok' if row['ok'] else 'FAIL'}")
    return row


def phase_kernels(torch, timer) -> tuple[list, dict, list]:
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, failures, report = [], [], {}
    for K, N in GEMM_SHAPES:
        xs = {M: torch.randn((M, K), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for M in GEMM_MS}
        for label, w, epi, dequantized in _gemm_cases(torch, K, N, gen):
            w_lib = dequantized()
            for M in GEMM_MS:
                row = _gemm_row(torch, timer, gc, label, xs[M], w, epi, w_lib)
                rows.append(row)
                if not row["ok"]:
                    failures.append(row)
                if (M, K, N) == REPORT_SHAPE and label in PRUNED_EPIS:
                    report[_report_name(label)] = row
            del w_lib
        del xs
        torch.cuda.empty_cache()
    # the decode rows at sparsity 0.3's widths, each weight stored as
    # prepare_serving stores it (rows padded to 16 bytes)
    for K, N in PRUNED_GEMMS:
        x = torch.randn((SLOTS, K), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        for label, w, epi, dequantized in _gemm_cases(torch, K, N, gen):
            if label not in PRUNED_EPIS:
                continue
            row = _gemm_row(torch, timer, gc, label, x, gc.aligned_rows(w),
                            epi, dequantized(), tag=" (pruned, padded rows)")
            rows.append(row)
            if not row["ok"]:
                failures.append(row)
            report[f"{_report_name(label)}.pruned.{K}x{N}"] = row
        torch.cuda.empty_cache()
    # the verify pass's heights on the tensor-core variant
    for K, N in VERIFY_SHAPES:
        xs = {M: torch.randn((M, K), generator=gen, device="cuda",
                             dtype=torch.bfloat16) for M in VERIFY_MS}
        for label, w, epi, dequantized in _gemm_cases(torch, K, N, gen):
            if label not in PRUNED_EPIS:
                continue
            w_lib = dequantized()
            for M in VERIFY_MS:
                row = _gemm_row(torch, timer, gc, label, xs[M], w, epi,
                                w_lib, tag=" (verify)")
                rows.append(row)
                if not row["ok"] or row["variant"] != "tc":
                    failures.append(row)
                report[f"{_report_name(label)}.verify.M{M}.{K}x{N}"] = row
            del w_lib
        del xs
        torch.cuda.empty_cache()

    KVh, g, dh = 8, 2, 128
    for B, S, pos in ((4, DECODE_S, DECODE_POS), (8, DECODE_S, DECODE_POS),
                      (4, LONG_S, LONG_POS)):
        # int64 pos and (in the helpers) bf16 q, as the layers hand them
        pos = torch.tensor(pos[:B], dtype=torch.int64, device="cuda")
        decode_rows = [_decode_check(torch, timer, gen, B, S, KVh, g, dh,
                                     pos)]
        decode_rows += [_paged_check(torch, timer, gen, B, S, KVh, g, dh,
                                     storage, pos)
                        for storage in ("bf16", "int8", "int4")]
        for row in decode_rows:
            rows.append(row)
            if not row["ok"]:
                failures.append(row)
            if B == SLOTS and S == DECODE_S:
                report[row["kernel"]] = row
            elif S == LONG_S:
                report[row["kernel"]]["at_S4096"] = {k: row[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms",
                    "max_abs_err")}
    return rows, report, failures


def _check_decode(torch, row, y, plain, mirror, tag="") -> None:
    """Hold a decode kernel's output to its plain version (rtol 1e-4) and
    to the split mirror (rtol 1e-5), both with atol relative to max|y|;
    the errors go under keys prefixed with `tag`, and a failure clears
    row["ok"]."""
    torch.cuda.synchronize()
    scale = plain.abs().max().item()
    row[tag + "max_abs_err"] = (y - plain).abs().max().item()
    row[tag + "atol"] = 1e-4 * scale
    row[tag + "split_max_abs_err"] = (y - mirror).abs().max().item()
    row["ok"] = row.get("ok", True) and bool(
        torch.allclose(y, plain, rtol=1e-4, atol=1e-4 * scale)
        and torch.allclose(y, mirror, rtol=1e-5, atol=1e-5 * scale)
        and torch.isfinite(y).all())


def _kernels_per_call(torch, fn, match: str = DECODE_KERNELS) -> int:
    """The device kernels whose names hold `match` (default: the
    decode-attention kernels; "" for every kernel) that one call of `fn`
    runs, read from a torch.profiler trace. A trace that recorded no device
    event at all (on the H100 a short trace now and then comes back
    empty, even three times in a row) is taken again, up to eight times:
    it measures nothing."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(8):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.events() if e.device_type == cuda]
        if names:
            break
    return sum(1 for name in names if match in name)


def _one_pos(pos):
    """Every slot at pos[0] through a stride-0 view, as the layers expand
    one position over the batch."""
    return pos[:1].expand(pos.numel())


def _sdpa(torch, q, k_rows, v_rows, pos):
    """The library yardstick: SDPA over the same (gathered, decoded) rows
    in bf16, heads expanded for GQA, masked to each slot's valid rows."""
    B, KVh, g, dh = q.shape
    S = k_rows.shape[1]
    ql = q.reshape(B, KVh * g, 1, dh).to(torch.bfloat16)
    kl, vl = (r.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
              .to(torch.bfloat16) for r in (k_rows, v_rows))
    mask = (torch.arange(S, device="cuda")[None, :]
            < torch.clamp(pos.long() + 1, max=S)[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(ql, kl, vl, attn_mask=mask)


def _decode_check(torch, timer, gen, B, S, KVh, g, dh, pos) -> dict:
    """The contiguous split-rows kernel on per-layer (strided) views of a
    stacked bf16 cache, against its plain version and the split mirror."""
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ref
    q = torch.randn((B, KVh, g, dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    cache = torch.randn((2, 2, B, S, KVh, dh), generator=gen,
                        device="cuda").to(torch.bfloat16)
    k, v = cache[0, 1], cache[1, 1]         # per-layer views, strided
    row = {"kernel": "decode_attn", "B": B, "S": S, "KVh": KVh, "g": g,
           "dh": dh, "R": da.ROWS_PER_SPLIT}
    for tag, p in (("", pos), ("one_pos_", _one_pos(pos))):
        _check_decode(torch, row, da.decode_attn(q, k, v, p),
                      ref.decode_attn_ref(q, k, v, p),
                      ref.decode_attn_split_ref(q, k, v, p,
                                                da.ROWS_PER_SPLIT), tag)
    row["ms"] = timer(lambda: da.decode_attn(q, k, v, pos))
    if B == SLOTS:
        row["rows_ms"] = {R: timer(lambda R=R: da.decode_attn(
            q, k, v, pos, rows_per_split=R)) for R in ROWS_PER_SPLIT}
    row["plain_ms"] = timer(lambda: ref.decode_attn_ref(q, k, v, pos))
    row["library_ms"] = timer(_sdpa(torch, q, k, v, pos))
    row["bound_ms"], row["bound_by"] = bound_ms(
        da.bytes_moved(q, k, pos), da.flops(q, k, pos))
    if B == SLOTS:      # after the timings: no profiler session before them
        row["kernels_per_call"] = _kernels_per_call(
            torch, lambda: da.decode_attn(q, k, v, pos))
    print(f"[3 kernels] decode_attn B={B} S={S} KVh={KVh} g={g} "
          f"dh={dh} ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
          f"library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
          f"err={row['max_abs_err']:.2e} tol={row['atol']:.2e} "
          f"vs split mirror {row['split_max_abs_err']:.2e} one pos "
          f"{row['one_pos_max_abs_err']:.2e}{_rows(row)} "
          f"{'ok' if row['ok'] else 'FAIL'}")
    return row


def _rows(row) -> str:
    r = row.get("rows_ms")
    return "" if r is None else (" R (" + ", ".join(
        f"{R}: {ms:.4f}" for R, ms in r.items()) + f" ms) kernels/call "
        f"{row['kernels_per_call']}")


def _paged_check(torch, timer, gen, B, S, KVh, g, dh, storage, pos) -> dict:
    """The page-indirect kernel on B slots of S rows in pages of PAGE rows,
    each slot's pages in a shuffled order, against its plain version and
    the split mirror (and, on bf16 pages, bitwise against the contiguous
    kernel on the gathered rows)."""
    from repro_torch.core.quant import kv_quant_encode
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ref
    Lp = -(-S // PAGE)
    n_pages = 2 + B * Lp
    table = (torch.randperm(n_pages - 2, generator=gen, device="cuda")
             + 2).reshape(B, Lp).to(torch.int32)
    q = torch.randn((B, KVh, g, dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    pools = [torch.randn((n_pages, PAGE, KVh, dh), generator=gen,
                         device="cuda") for _ in range(2)]
    kw = dict(page_size=PAGE, seq_len=S)
    if storage == "bf16":
        kp, vp = (p.to(torch.bfloat16) for p in pools)
    else:
        bits = int(storage[-1])
        (kp, ks), (vp, vs) = (kv_quant_encode(p, bits) for p in pools)
        kw.update(kv_bits=bits, k_scale=ks, v_scale=vs)
    del pools
    y = da.paged_decode_attn(q, kp, vp, pos, table, **kw)
    row = {"kernel": f"paged_decode_attn.{storage}", "B": B, "S": S,
           "P": PAGE, "KVh": KVh, "g": g, "dh": dh, "R": da.ROWS_PER_SPLIT}
    for tag, p in (("", pos), ("one_pos_", _one_pos(pos))):
        _check_decode(torch, row,
                      da.paged_decode_attn(q, kp, vp, p, table, **kw),
                      ref.paged_decode_attn_ref(q, kp, vp, p, table, **kw),
                      ref.paged_decode_attn_split_ref(
                          q, kp, vp, p, table,
                          rows_per_split=da.ROWS_PER_SPLIT, **kw), tag)
    # the gathered (and decoded) rows: the contiguous kernel's input on
    # bf16 pages, and the library yardstick's in every storage
    rows_k, rows_v = (ref.gather_pages(pool, kw.get(sc), table, PAGE, S,
                                       kw.get("kv_bits"))
                      for pool, sc in ((kp, "k_scale"), (vp, "v_scale")))
    if storage == "bf16":
        contiguous = da.decode_attn(q, rows_k, rows_v, pos)
        torch.cuda.synchronize()
        row["contiguous_max_abs_err"] = (y - contiguous).abs().max().item()
        row["ok"] = row["ok"] and torch.equal(y, contiguous)
    row["ms"] = timer(lambda: da.paged_decode_attn(q, kp, vp, pos, table,
                                                   **kw))
    if B == SLOTS:
        row["rows_ms"] = {R: timer(lambda R=R: da.paged_decode_attn(
            q, kp, vp, pos, table, rows_per_split=R, **kw))
            for R in ROWS_PER_SPLIT}
    row["plain_ms"] = timer(lambda: ref.paged_decode_attn_ref(
        q, kp, vp, pos, table, **kw))
    row["library_ms"] = timer(_sdpa(torch, q, rows_k, rows_v, pos))
    row["bound_ms"], row["bound_by"] = bound_ms(
        da.paged_bytes_moved(q, kp, pos, PAGE, S, kw.get("kv_bits")),
        da.paged_flops(q, pos, S))
    if B == SLOTS:      # after the timings: no profiler session before them
        row["kernels_per_call"] = _kernels_per_call(
            torch, lambda: da.paged_decode_attn(q, kp, vp, pos, table, **kw))
    bitwise = (f" vs contiguous kernel max|diff|="
               f"{row['contiguous_max_abs_err']:.1e}"
               if storage == "bf16" else "")
    print(f"[3 kernels] paged_decode_attn {storage} B={B} S={S} P={PAGE} "
          f"KVh={KVh} g={g} dh={dh} ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} "
          f"library_ms={row['library_ms']:.4f} (SDPA on gathered rows) "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
          f"err={row['max_abs_err']:.2e} tol={row['atol']:.2e} "
          f"vs split mirror {row['split_max_abs_err']:.2e} one pos "
          f"{row['one_pos_max_abs_err']:.2e}{_rows(row)}{bitwise} "
          f"{'ok' if row['ok'] else 'FAIL'}")
    return row

def _fq_rows(torch, timer, gen) -> tuple[list, dict, list]:
    """The fake-quant kernels at the training path's shapes."""
    from repro_torch.core.quant import init_quant_params
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels import ref
    rows, report, failures = [], {}, []
    cases = [(label, shape, torch.bfloat16)
             for label, shape in FQ_SHAPES.items()] + [
        (label, shape, torch.float32)
        for label, shape in CNN_FQ_SHAPES.items()]
    for label, shape, dtype in cases:
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=dtype) * shape[0] ** -0.5
        if label.endswith("_act"):          # a ReLU's output
            x = torch.relu(x)
        g = torch.randn(shape, generator=gen, device="cuda",
                        dtype=dtype) * 1e-3
        for t in (1.0, 0.85):
            qp = init_quant_params(q_m=x.float().abs().max() * 0.9, bits=8.0,
                                   t=t)
            sc = (qp.d, qp.q_m, qp.t)
            y, want = fq.fake_quant_fwd(x, *sc), ref.fake_quant_fwd_ref(x, *sc)
            torch.cuda.synchronize()
            err = (y.float() - want.float()).abs().max().item()
            # bitwise at every t: the kernel and torch.pow take one powf
            ok = torch.equal(y, want)
            row = {"kernel": "fake_quant.fwd", "w": label, "shape": shape,
                   "t": t, "max_abs_err": err, "bitwise": torch.equal(y, want),
                   "ok": ok, "library_ms": None,
                   "ms": timer(lambda: fq.fake_quant_fwd(x, *sc)),
                   "plain_ms": timer(lambda: ref.fake_quant_fwd_ref(x, *sc))}
            row["bound_ms"], row["bound_by"] = bound_ms(fq.fwd_bytes(x), 0)
            _one_kernel(torch, row, lambda: fq.fake_quant_fwd(x, *sc))
            rows.append(row)
            del y, want
            got = fq.fake_quant_bwd(x, *sc, g)
            want = ref.fake_quant_bwd_ref(x, *sc, g)
            torch.cuda.synchronize()
            again = fq.fake_quant_bwd(x, *sc, g)
            scales = fq.sum_scales(x, g, *sc)
            serr = [abs(float(a) - float(b)) / max(s, 1e-30)
                    for a, b, s in zip(got[1:], want[1:], scales)]
            dx_same = torch.equal(got[0], want[0])
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            brow = {"kernel": "fake_quant.bwd", "w": label, "shape": shape,
                    "t": t, "max_abs_err": (got[0].float()
                                            - want[0].float()).abs().max()
                    .item(), "dx_bitwise": dx_same,
                    "sum_err_over_scale": serr, "repeat_bitwise": repeat,
                    "ok": dx_same and repeat and max(serr) <= 1e-5,
                    "library_ms": None,
                    "ms": timer(lambda: fq.fake_quant_bwd(x, *sc, g)),
                    "plain_ms": timer(lambda: ref.fake_quant_bwd_ref(
                        x, *sc, g))}
            brow["bound_ms"], brow["bound_by"] = bound_ms(fq.bwd_bytes(x, g),
                                                          0)
            _one_kernel(torch, brow, lambda: fq.fake_quant_bwd(x, *sc, g))
            rows.append(brow)
            del got, want, again
            for r in (row, brow):
                print(f"[3 kernels] {r['kernel']:<29} {label:<6} "
                      f"{'x'.join(map(str, shape))} {str(dtype)[6:]} t={t} "
                      f"ms={r['ms']:.4f} "
                      f"plain_ms={r['plain_ms']:.4f} library_ms=none "
                      f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
                      f"err={r['max_abs_err']:.2e}"
                      + (f" bitwise={r['bitwise']}" if "bitwise" in r else
                         f" dx_bitwise={r['dx_bitwise']} sums/scale="
                         f"{max(r['sum_err_over_scale']):.1e} repeat_bitwise="
                         f"{r['repeat_bitwise']}")
                      + f"{_per_call(r)} {'ok' if r['ok'] else 'FAIL'}")
                if not r["ok"]:
                    failures.append(r)
                key = (r["kernel"] if TRAIN_REPORT[r["kernel"]][0] == label
                       else f"{r['kernel']}.{label}"
                       if label in CNN_FQ_SHAPES else None)
                if key is not None:
                    report[key if t == 1.0 else key + ".at_t0.85"] = r
        del x, g
        torch.cuda.empty_cache()
    return rows, report, failures


def _operand(torch, gen, shape, transposed, scale=1.0):
    """A random bf16 (rows, cols) operand, row-major or the transposed view
    of a row-major (cols, rows) array."""
    rows, cols = shape
    t = torch.randn((cols, rows) if transposed else (rows, cols),
                    generator=gen, device="cuda",
                    dtype=torch.bfloat16) * scale
    return t.T if transposed else t


def _train_gemm_rows(torch, timer, gen) -> tuple[list, dict, list]:
    """The GEMM core's training epilogues at the training path's shapes and
    layouts (M = 2048: the tensor-core variant)."""
    from repro_torch.core.quant import init_quant_params
    from repro_torch.kernels import gemm_core as gc
    rows, report, failures = [], {}, []
    for case in TRAIN_GEMMS:
        label, M, K, N, layout, t, bits = case
        x = _operand(torch, gen, (M, K), layout.startswith("x.T"))
        w = _operand(torch, gen, (K, N), layout.endswith("w.T"), K ** -0.5)
        mask = (torch.rand((N,), generator=gen, device="cuda") > 0.3).float()
        qp = init_quant_params(w, bits=float(bits), t=t)
        epi = {"none": gc.none(), "col_mask": gc.col_mask(mask),
               "fake_quant_rhs": gc.fake_quant_rhs(qp.d, qp.q_m, qp.t),
               "fq_col_mask": gc.fq_col_mask(qp.d, qp.q_m, qp.t, mask)}[label]
        # checked in f32 like the serving rows; timed in the path's out
        # dtype, bf16 (dwq is written in the weight's dtype, and its bf16
        # output must be the f32 output rounded, bit for bit)
        out = torch.bfloat16
        y = gc.gemm(x, w, epi, out_dtype=torch.float32)
        want = gc.plain(x, w, epi, torch.float32)
        rounded = torch.equal(gc.gemm(x, w, epi, out_dtype=out),
                              y.to(out))
        torch.cuda.synchronize()
        err = (y - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        ok = bool(torch.allclose(y, want, rtol=1e-4, atol=tol)
                  and torch.isfinite(y).all()) and rounded
        if label in ("col_mask", "fq_col_mask"):
            ok = ok and not y[:, mask == 0].any()
        del y, want
        w_lib = (w.float() * mask if label == "col_mask" else
                 gc.ref.fake_quant_weight(w.float(), qp.d, qp.q_m, qp.t)
                 * (mask if label == "fq_col_mask" else 1.0)
                 if label != "none" else w.float()).to(torch.bfloat16)
        variant = gc.variant(M, torch.bfloat16)
        row = {"kernel": f"gemm_core.{label}", "M": M, "K": K, "N": N,
               "layout": layout, "t": t, "bits": bits, "variant": variant,
               "out": str(out), "max_abs_err": err, "atol": tol,
               "bf16_is_f32_rounded": rounded, "ok": ok,
               "ms": timer(lambda: gc.gemm(x, w, epi, out_dtype=out)),
               "plain_ms": timer(lambda: gc.plain(x, w, epi, out)),
               "library_ms": timer(lambda: torch.matmul(x, w_lib))}
        row["bound_ms"], row["bound_by"] = bound_ms(
            gc.bytes_moved(M, N, K, 2, w, out.itemsize, epi),
            gc.flops(M, N, K))
        if variant == "tc":
            row["heights"] = _height_ms(
                timer, gc, lambda: gc.gemm(x, w, epi, out_dtype=out), M, N)
        _one_kernel(torch, row, lambda: gc.gemm(x, w, epi, out_dtype=out))
        rows.append(row)
        if not row["ok"]:
            failures.append(row)
        print(f"[3 kernels] {row['kernel']:<29} M={M:<4} K={K:<4} N={N:<5} "
              f"{layout} t={t} bits={bits} {variant} "
              f"out={str(out)[6:]} ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"err={err:.2e} tol={tol:.2e} bf16_is_f32_rounded={rounded}"
              f"{_heights(row)}{_per_call(row)} "
              f"{'ok' if row['ok'] else 'FAIL'}")
        for name, key in TRAIN_REPORT.items():
            if key == case:
                report[name] = row
        if case == AT_T085:
            report["at_t0.85"] = row
        del x, w, w_lib
        torch.cuda.empty_cache()
    return rows, report, failures


def _simt_gemm_rows(torch, timer, gen) -> tuple[list, dict, list]:
    """The SIMT variant (f32 x, f32 weights: the f32 configuration's
    operands, which keep f32 products) at the model's prefill and training
    rows, against its plain version at the same bounds."""
    from repro_torch.core.quant import init_quant_params
    from repro_torch.kernels import gemm_core as gc
    rows, report, failures = [], {}, []
    f32 = torch.float32
    for case in SIMT_GEMMS:
        label, M, K, N, t = case
        x = torch.randn((M, K), generator=gen, device="cuda")
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        qp = init_quant_params(w, bits=8.0, t=t)
        epi = (gc.none() if label == "none" else
               gc.fake_quant_rhs(qp.d, qp.q_m, qp.t))
        y = gc.gemm(x, w, epi, out_dtype=f32)
        again = gc.gemm(x, w, epi, out_dtype=f32)
        want = gc.plain(x, w, epi, f32)
        torch.cuda.synchronize()
        err = (y - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        ok = bool(torch.allclose(y, want, rtol=1e-4, atol=tol)
                  and torch.isfinite(y).all() and torch.equal(y, again))
        del y, again, want
        w_lib = (w if label == "none" else
                 gc.ref.fake_quant_weight(w, qp.d, qp.q_m, qp.t))
        row = {"kernel": f"gemm_core.{label}", "M": M, "K": K, "N": N,
               "t": t, "variant": gc.variant(M, f32), "out": str(f32),
               "max_abs_err": err, "atol": tol,
               "ok": ok and gc.variant(M, f32) == "simt",
               "ms": timer(lambda: gc.gemm(x, w, epi, out_dtype=f32)),
               "plain_ms": timer(lambda: gc.plain(x, w, epi, f32)),
               "library_ms": timer(lambda: torch.matmul(x, w_lib))}
        row["bound_ms"], row["bound_by"] = bound_ms(
            gc.bytes_moved(M, N, K, 4, w, 4, epi), gc.flops(M, N, K),
            F32_FLOP_PER_S)
        rows.append(row)
        if not row["ok"]:
            failures.append(row)
        print(f"[3 kernels] {row['kernel']:<29} M={M:<4} K={K:<4} N={N:<5} "
              f"t={t} f32 x, f32 w {row['variant']} ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} (f32) "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"err={err:.2e} tol={tol:.2e} {'ok' if row['ok'] else 'FAIL'}")
        if case == SIMT_REPORT:
            report["gemm_core.simt.fake_quant_rhs"] = row
        elif case[0] == "fake_quant_rhs" and t != 1.0:
            report["simt_at_t0.85"] = row
        del x, w, w_lib
        torch.cuda.empty_cache()
    return rows, report, failures


def phase_train_kernels(torch, timer) -> tuple[list, dict, list]:
    """Phase 3's training half: the fake-quant kernels and the GEMM's
    training variants at the full-width training shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, report, failures = _fq_rows(torch, timer, gen)
    for part in (_train_gemm_rows, _simt_gemm_rows):
        r2, rep2, f2 = part(torch, timer, gen)
        rows, failures = rows + r2, failures + f2
        report.update(rep2)
    return rows, report, failures


def phase_correctness(torch) -> tuple[dict, list[str]]:
    """Full-width prefill vs sequential decode, and smoke card vs CPU.
    Returns the launch counts of the smoke config's card runs (f32: its
    prefill GEMMs take the SIMT variant) and the failures."""
    from repro_torch.configs import get_arch
    from repro_torch.core.subnet import prepare_serving
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import (WEIGHT_MODES, serve_on_devices,
                                           synthetic_prompts)
    from repro_torch.models.transformer import LM
    failures = []
    lm = LM(get_arch(ARCH))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, qparams, _ = prepare_serving(lm, lm.init(gen), compressed=True)
    prompt = torch.as_tensor(synthetic_prompts(lm.cfg, [32], seed=1)[0],
                             dtype=torch.int64, device="cuda")[None]
    cache = lm.init_cache(1, 32, dtype=torch.bfloat16, device="cuda")
    pre, _ = lm.prefill(params, qparams, cache, prompt)
    cache = lm.init_cache(1, 32, dtype=torch.bfloat16, device="cuda")
    for p in range(32):
        dec, _ = lm.decode_step(params, qparams, cache, prompt[:, p:p + 1], p)
    a, b = pre[0, -1].float(), dec[0, -1].float()
    diff = (a - b).abs().max().item()
    scale = a.abs().max().item()
    top2 = torch.topk(a, 2).values
    same_argmax = int(a.argmax()) == int(b.argmax())
    # bf16 activations through 24 layers, summed in another order
    # (prefill M = 32 vs decode M = 1 tiles): 2^-5 of the logit range
    ok = (same_argmax and diff <= scale / 32
          and bool(torch.isfinite(pre).all() and torch.isfinite(dec).all())
          and pre.shape == (1, 32, lm.cfg.vocab_padded))
    print(f"[4 correctness] full-width compressed prefill vs 32 decode "
          f"steps, last-position logits: max|diff|={diff:.4f} "
          f"max|logit|={scale:.4f} (tol {scale / 32:.4f}), top-2 gap "
          f"{(top2[0] - top2[1]).item():.4f}, argmax "
          f"{int(a.argmax())} vs {int(b.argmax())} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("prefill vs sequential decode")
    del params, qparams, cache, pre, dec
    torch.cuda.empty_cache()

    # the smoke config on both devices from the same weights
    ops.reset_launch_counts()
    for mode, kw in WEIGHT_MODES.items():
        toks = serve_on_devices(ARCH, True, [6, 3, 9], 6, ["cpu", "cuda"],
                                max_slots=2, **kw)
        cpu, card = toks["cpu"], toks["cuda"]
        ok = all((cpu[r] == card[r]).all() for r in cpu)
        print(f"[4 correctness] smoke config {mode}: card tokens "
              f"{'equal' if ok else 'DIFFER FROM'} the CPU plain versions' "
              f"({sum(len(t) for t in cpu.values())} tokens)")
        if not ok:
            failures.append(f"smoke {mode} card vs cpu")
    counts = _nonzero(ops.launch_counts())
    simt = counts.get("gemm_core.simt", 0)
    print(f"[4 correctness] smoke config card launches {counts}: the f32 "
          f"prefill GEMMs on the SIMT variant {simt} times "
          f"{'ok' if simt > 0 else 'FAIL'}")
    if simt <= 0:
        failures.append("the SIMT variant never launched on the f32 path")
    return counts, failures


_CAPTURES = [0]      # CUDA graph captures in this process
_TRACE_TAKES = []    # {"engine", "takes"} of every traced drain


def _count_captures(torch) -> None:
    """Count every CUDA graph capture as it starts (`torch.cuda.graph`)."""
    enter = torch.cuda.graph.__enter__

    def counted(self):
        _CAPTURES[0] += 1
        return enter(self)

    torch.cuda.graph.__enter__ = counted


def _gemm_tally(gc, tally):
    """Wrap `gc.gemm` so that each CUDA call adds one to tally[(variant,
    epilogue)]; returns the unwrapped function (restore it after)."""
    real = gc.gemm

    def tallied(x, w, epi, **kw):
        out = real(x, w, epi, **kw)
        if x.is_cuda:
            tally[(gc.variant(x.shape[0], x.dtype), epi.name)] += 1
        return out

    tallied.launches = real.launches
    gc.gemm = tallied
    return real


def _trace_drain(torch, eng, prompts, label, spec=False, gen=TRACE_GEN
                 ) -> tuple[dict, dict, int, int]:
    """Serve the first SLOTS prompts once more, `gen` tokens each
    (windows of 16, 4, 2 and 1 steps, or, `spec`, speculative rounds),
    under a profiler trace of the card. Returns the tokens, {kernel
    family: (kernels in the trace, launches expected)}, the decode
    steps traced and the takes the trace needed (also kept under
    `label` in _TRACE_TAKES, which the --out JSON holds). Expected are the eager calls the wrappers made during
    the drain (the prefills; no capture happens in it) plus each replayed
    graph's captured calls. Families: every small-M GEMM, the small-M
    GEMM of each epilogue (its first template argument; `spec`: every
    tensor-core GEMM instead, since a round's graph holds GEMMs of both
    variants, which the launch counts do not tell apart by epilogue), and
    the decode-attention split and combine kernels. The drain is short
    since a long trace loses events (on the
    H100, drains of 8 requests x 64 tokens, ~170k kernels each, came back
    a few to a few hundred kernels short in 6 of 10 engines); a trace
    that still lost some is taken again, up to three times. A session
    also lost its first few kernels now and then (the drain's first
    prefill GEMMs), so each starts with TRACE_WARMUP fill kernels,
    which no family counts."""
    from collections import Counter
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import ops
    cuda = torch.autograd.DeviceType.CUDA
    for takes in range(1, 4):
        for p in prompts[:SLOTS]:
            eng.submit(p, gen)
        g0, h0, tally = (Counter(eng.graph_device_launches()),
                         ops.launch_counts(), Counter())
        steps0 = eng.stats["decode_steps"]
        real = _gemm_tally(gc, tally)
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                warm = torch.zeros(1, device="cuda")
                for _ in range(TRACE_WARMUP):
                    warm.fill_(1.0)
                torch.cuda.synchronize()
                out = eng.run()
                torch.cuda.synchronize()
        finally:
            gc.gemm = real
        names = Counter(e.name for e in prof.events() if e.device_type == cuda)
        replayed = Counter(eng.graph_device_launches()) - g0
        host = {k: v - h0[k] for k, v in ops.launch_counts().items()}
        attn = sum(v for k, v in host.items() if "decode_attn" in k) + sum(
            v for k, v in replayed.items() if "decode_attn" in k)
        fam = {"gemm_small_m": (
            sum(v for k, v in names.items() if "gemm_small_m" in k),
            sum(v for (var, _), v in tally.items() if var == "small_m")
            + replayed["gemm_core.small_m"])}
        if spec:
            fam["gemm_tc"] = (
                sum(v for k, v in names.items() if "gemm_tc" in k),
                sum(v for (var, _), v in tally.items() if var == "tc")
                + replayed["gemm_core.tc"])
        for epi in () if spec else ("fake_quant_rhs", "dequant",
                                    "unpack_dequant"):
            tag = f"gemm_small_m<{gc._EPI_CODE[epi]},"
            fam[f"gemm_small_m.{epi}"] = (
                sum(v for k, v in names.items() if tag in k.replace(" ", "")),
                tally[("small_m", epi)] + replayed[f"gemm_core.{epi}"])
        for kern in ("flash_decode_split", "flash_decode_combine"):
            fam[kern] = (sum(v for k, v in names.items() if kern in k), attn)
        if all(got >= want for got, want in fam.values()):
            break
    if not spec:
        # every captured GEMM of a window is a small-M one (M = the slots)
        fam["graph_gemms_small_m"] = (
            replayed["gemm_core.small_m"],
            sum(replayed[f"gemm_core.{e}"] for e in gc._EPI_CODE))
    _TRACE_TAKES.append({"engine": label, "takes": takes})
    return out, fam, eng.stats["decode_steps"] - steps0, takes


def _serve_full(torch, prompts, kw) -> tuple[dict, dict, list[str]]:
    """One engine at full width: build, submit, warm up (which captures
    the window graphs), drain; then the first requests again, shorter,
    under a profiler trace (`_trace_drain`), and all of them again through
    eager `step()`.
    Returns the first drain's tokens, its stats (with the capture's time,
    graph pool bytes, peak memory and the trace's families) and the
    failures: tokens that differ between the three drains, a capture
    inside a drain, a trace family off its expected count."""
    from repro_torch.launch.engine import build_engine
    failures = []
    eng, _ = build_engine(ARCH, False, max_slots=SLOTS,
                          max_seq=max(PROMPT_LENS) + GEN, device="cuda", **kw)
    for p in prompts:
        eng.submit(p, GEN)
    torch.cuda.reset_peak_memory_stats()
    eng.warmup()
    peak = torch.cuda.max_memory_allocated()
    captured = _CAPTURES[0]
    out = eng.run()
    stats = dict(eng.stats, **eng.throughput(), kv_bytes=eng.kv_bytes(),
                 kv_pool_bytes=eng.kv_pool_bytes(),
                 param_bytes=eng.param_bytes(),
                 param_alloc_bytes=eng.serving_meta["param_alloc_bytes"],
                 block_weight_bytes=_block_weight_bytes(eng.params),
                 sparsity=eng.serving_meta.get("sparsity"),
                 shapes=eng.lm.shapes[0],
                 graph_pool_bytes=eng.graph_pool_bytes, peak_bytes=peak,
                 graphs=sorted(eng.graphs), replays=dict(eng.replays))
    traced, fam, stats["traced_steps"], stats["trace_takes"] = _trace_drain(
        torch, eng, prompts, repr(kw))
    stats["trace"] = fam
    for p in prompts:
        eng.submit(p, GEN)
    eager = eng._drain(eng.step)
    if _CAPTURES[0] != captured:
        failures.append("a CUDA graph was captured inside run()")
    if sorted(eng.graphs) != eng.warmed_window_ks():
        failures.append("warmup() did not capture every window length")
    for name, (got, want) in fam.items():
        if got != want:
            failures.append(f"trace: {got} {name} kernels, {want} expected")
    stats["graph_eq_traced"] = _same(
        {r: out[r][:TRACE_GEN] for r in sorted(out)[:SLOTS]}, traced)
    stats["graph_eq_eager"] = _same(out, eager)
    if not (stats["graph_eq_traced"] and stats["graph_eq_eager"]):
        failures.append("graph-window tokens differ from a second drain or "
                        "from eager steps")
    del eng
    torch.cuda.empty_cache()
    return out, stats, failures


def _block_weight_bytes(params: dict) -> int:
    """Logical bytes of the served block projections (dense weights, codes
    or packed words; not the norms, not the scales)."""
    return sum(v.numel() * v.element_size() for k, v in params.items()
               if k.startswith("blocks.") and (".attn." in k or ".mlp." in k)
               and not k.endswith(".scale"))


def _predicted_block_bytes(cfg, shp, mode: str) -> int:
    """The block projections' bytes at the widths `shp` in a weight mode,
    from the shapes alone: weights in the config's dtype (dense), int8
    codes (compressed, 8-bit init) or 4-bit codes packed 8 to an int32
    word along K (packed_b4)."""
    D, dh = cfg.d_model, cfg.d_head
    Q, KV, F = shp.n_heads * dh, shp.n_kv_heads * dh, shp.d_ff
    mats = [(D, Q), (D, KV), (D, KV), (Q, D), (D, F), (D, F), (F, D)]
    item = 2 if cfg.dtype == "bfloat16" else 4
    per = {"dense": lambda K, N: item * K * N,
           "compressed": lambda K, N: K * N,
           "packed_b4": lambda K, N: 4 * -(-K // 8) * N}[mode]
    return cfg.n_layers * sum(per(K, N) for K, N in mats)


def _same(a: dict, b: dict) -> bool:
    """Two drains of the same requests emitted the same tokens, request by
    request in submission order (a later drain's requests have new ids)."""
    return len(a) == len(b) and all(
        np.array_equal(a[r], b[q]) for r, q in zip(sorted(a), sorted(b)))


def _graph_line(st) -> str:
    fam = st["trace"]
    return (f"graphs {st['graphs']} captured in {st['capture_s']:.2f} s, "
            f"pool {st['graph_pool_bytes'] / 2 ** 20:.1f} MiB, peak "
            f"{st['peak_bytes'] / 2 ** 30:.2f} GiB, replays {st['replays']}; "
            f"tokens {'equal' if st['graph_eq_eager'] else 'DIFFER FROM'} "
            f"eager step()'s and "
            f"{'equal' if st['graph_eq_traced'] else 'DIFFER FROM'} a "
            f"traced drain's ({SLOTS} requests x {TRACE_GEN} tokens, "
            f"{st['traced_steps']} steps, trace taken "
            f"{st['trace_takes']}x); trace kernels (seen, expected) "
            + ", ".join(f"{k} {v[0]}/{v[1]}" for k, v in fam.items()
                        if v[1]))


def phase_engine(torch) -> tuple[dict, dict, list[str], dict, dict]:
    """Phase 5 (see the module docstring). Returns the launch counts, the
    tokens per mode, the failures, the trace families summed over the
    modes and the stats per mode."""
    from collections import Counter
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import (WEIGHT_MODES, engine_serve,
                                           synthetic_prompts)
    expect = {"dense": "gemm_core.fake_quant_rhs",
              "compressed": "gemm_core.dequant",
              "packed_b4": "gemm_core.unpack_dequant"}
    failures, outs, seen, by_mode = [], {}, Counter(), {}
    prompts = synthetic_prompts(get_arch(ARCH), PROMPT_LENS, seed=0)
    ops.reset_launch_counts()
    for mode, kw in WEIGHT_MODES.items():
        before = ops.launch_counts()
        t0 = time.perf_counter()
        toks, stats, fails = _serve_full(torch, prompts, kw)
        wall = time.perf_counter() - t0
        outs[mode], by_mode[mode] = toks, stats
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        fam = stats["trace"]
        epi = expect[mode].split(".")[1]
        ok = (not fails and len(toks) == len(PROMPT_LENS)
              and all(len(t) == GEN and t.min() >= 0 and t.max() < 92672
                      for t in toks.values())
              and delta[expect[mode]] > 0 and delta["decode_attn"] > 0
              and delta["gemm_core.small_m"] > 0
              and fam[f"gemm_small_m.{epi}"][0] > 0
              and fam["flash_decode_split"][0] > 0)
        for name, (got, _) in fam.items():
            seen[name] += got
        print(f"[5 engine] {mode}: decode {stats['decode_tok_per_s']:.1f} "
              f"tok/s ({stats['decode_tokens']} tokens in "
              f"{stats['decode_s']:.3f} s, {stats['decode_steps']} steps), "
              f"prefill {stats['prefill_tok_per_s']:.1f} tok/s "
              f"({stats['prefill_tokens']} tokens in "
              f"{stats['prefill_s']:.3f} s), param_bytes "
              f"{stats['param_bytes']}, kv_bytes {stats['kv_bytes']}, host "
              f"launches "
              f"{_nonzero(delta)}, wall {wall:.1f} s; {_graph_line(stats)} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"engine {mode}: {fails}")
    counts = ops.launch_counts()
    print(f"[5 engine] main-path launch counts (host calls; a graph's "
          f"calls count once, at capture): {_nonzero(counts)}")
    for name in [*expect.values(), "decode_attn", "fake_quant.fwd",
                 "gemm_core.small_m", "gemm_core.tc"]:
        if counts[name] <= 0:
            failures.append(f"{name} never launched on the main path")
    ref_int8 = engine_serve(ARCH, False, PROMPT_LENS, GEN, max_slots=SLOTS,
                            verbose=False, device="cuda", compressed=True,
                            bits_init=4.0)
    same = _same(ref_int8, outs["packed_b4"])
    print(f"[5 engine] packed 4-bit tokens "
          f"{'equal' if same else 'DIFFER FROM'} the int8 run at the same "
          f"4-bit quantizer init ({len(ref_int8)} requests x {GEN} tokens)")
    if not same:
        failures.append("packed tokens differ from int8 tokens")
    return counts, outs, failures, dict(seen), by_mode


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def phase_paged(torch, contiguous: dict) -> tuple[dict, list[str], dict]:
    """The paged main path at full width (see the module docstring)."""
    from collections import Counter
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import WEIGHT_MODES, synthetic_prompts
    failures, seen = [], Counter()
    prompts = synthetic_prompts(get_arch(ARCH), PROMPT_LENS, seed=0)
    n_layers = get_arch(ARCH).n_layers

    def serve(label, prompts, kw, check):
        out, st, fails = _serve_full(
            torch, prompts, dict(kw, paged=True, page_size=PAGE))
        split = st["trace"]["flash_decode_split"][0]
        per_step = split / max(st["traced_steps"], 1)
        storage = {None: "bf16", 8: "int8", 4: "int4"}[kw.get("kv_bits")]
        seen[f"flash_decode_split.{storage}"] += split
        full = (len(out) == len(prompts)
                and all(len(t) == GEN for t in out.values()))
        ok, what = check(out, st)
        ok = ok and full and not fails and per_step == n_layers
        for name, (got, _) in st["trace"].items():
            seen[name] += got
        print(f"[6 paged] {label}, {what}: decode "
              f"{st['decode_tok_per_s']:.1f} tok/s ({st['decode_tokens']} "
              f"tokens, {st['decode_steps']} steps), prefill "
              f"{st['prefill_tok_per_s']:.1f} tok/s ({st['prefills']} "
              f"prefills, {st['prefix_hits']} prefix hits), kv_bytes "
              f"{st['kv_bytes']}, kv_pool_bytes {st['kv_pool_bytes']}, "
              f"page-indirect split kernels per decode step (trace) "
              f"{per_step:.2f}; {_graph_line(st)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"paged {label}: {fails}")
        return out, st

    ops.reset_launch_counts()
    runs = {}
    for mode, kw in WEIGHT_MODES.items():
        runs[mode] = serve(
            f"{mode}, bf16 pages", prompts, kw,
            lambda out, st, mode=mode: (
                _same(out, contiguous[mode]),
                "tokens " + ("equal" if _same(out, contiguous[mode])
                             else "DIFFER FROM") + " the contiguous run's"))
    bf16_out, bf16_st = runs["packed_b4"]
    for bits in (8, 4):
        def quantized(out, st):
            first = all(out[r][0] == bf16_out[r][0] for r in out)
            smaller = st["kv_pool_bytes"] < bf16_st["kv_pool_bytes"]
            return first and smaller, (
                f"first tokens {'equal' if first else 'DIFFER FROM'} the "
                f"bf16-page run's, pool {st['kv_pool_bytes']} B vs "
                f"{bf16_st['kv_pool_bytes']} B")
        serve(f"packed_b4, int{bits} pages", prompts,
              dict(WEIGHT_MODES["packed_b4"], kv_bits=bits), quantized)
    shared = [prompts[5] if i in SHARED else p for i, p in enumerate(prompts)]
    kw = WEIGHT_MODES["compressed"]
    want, _ = serve(
        f"compressed, {len(SHARED)} of {len(shared)} requests on one prompt, "
        f"no prefix sharing", shared, dict(kw, prefix_sharing=False),
        lambda out, st: (all(_same({0: out[i]}, {0: out[SHARED[0]]})
                             for i in SHARED), "their tokens agree"))
    serve(f"compressed, {len(SHARED)} of {len(shared)} requests on one "
          f"prompt, prefix sharing", shared, kw,
          lambda out, st: (_same(out, want)
                           and st["prefix_hits"] >= len(SHARED) - 1,
                           "tokens equal the run without sharing"))
    counts = ops.launch_counts()
    print(f"[6 paged] main-path launch counts (host calls; a graph's calls "
          f"count once, at capture): {_nonzero(counts)}")
    for name in ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
                 "gemm_core.unpack_dequant", *PAGED_KERNELS):
        if counts[name] <= 0:
            failures.append(f"{name} never launched on the paged path")
    if counts["decode_attn"]:
        failures.append("the paged path launched the contiguous kernel")
    return counts, failures, dict(seen)


def _first_step_logits(torch, eng, prompts, gen) -> "torch.Tensor":
    """Submit `prompts` (`gen` tokens each) to `eng`, admit them and return
    the (slots, V) f32 logits of its first batched decode step, on the
    slots' state as `run()` would stage it. The step writes the K/V rows
    `run()`'s first step writes again, so the engine may then be warmed
    up and run."""
    for p in prompts:
        eng.submit(p, gen)
    eng._admit()
    eng._stage()
    with torch.no_grad():
        logits, _ = eng.lm.decode_step(eng._run_params, eng._run_qparams,
                                       eng.caches, eng._static["tok"],
                                       eng._static["pos"], eng._pages())
    return logits[:, -1].float()


def _held_to_masked(torch, label, got, want, toks, ref_toks) -> tuple:
    """Phase 8's comparison of a pruned engine with its masked reference:
    the first decode step's logits within MASKED_TOL of the logit range
    with the same argmax per slot (checked), greedy-token agreement and
    the first divergence per request (printed). Returns (ok, line)."""
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    same_argmax = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    ok = diff <= MASKED_TOL * scale and same_argmax
    agree, first = [], []
    for r in sorted(ref_toks):
        a, b = toks[r], ref_toks[r]
        eq = a == b
        agree.append(float(eq.mean()))
        first.append(int(np.argmin(eq)) if not eq.all() else None)
    line = (f"{label}: first decode step's logits vs the masked reference "
            f"max|diff| {diff:.4f} of max|logit| {scale:.4f} (tol "
            f"{MASKED_TOL} x, {diff / max(scale, 1e-30):.2e}), argmax "
            f"{'equal' if same_argmax else 'DIFFERS'} "
            f"{'ok' if ok else 'FAIL'}; greedy tokens agree "
            f"{np.mean(agree):.3f} (per request {[round(a, 3) for a in agree]}"
            f"), first divergence {first}")
    return ok, line


def phase_pruned(torch, full: dict, geta) -> tuple[dict, list[str], dict]:
    """Phase 8 (see the module docstring). `full`: phase 5's stats per
    mode; `geta`: phase 7's final (params, qparams, keep masks). Returns
    the launch counts of the pruned main path, the failures and its trace
    families summed over the modes."""
    from collections import Counter
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import (WEIGHT_MODES,
                                           build_masked_reference_engine,
                                           engine_serve, synthetic_prompts)
    from repro_torch.models.layers import LayerShapes
    cfg = get_arch(ARCH)
    prompts = synthetic_prompts(cfg, PROMPT_LENS, seed=0)
    prune = dict(pruned=True, sparsity=PRUNE_SPARSITY)
    expect = {"dense": "gemm_core.fake_quant_rhs",
              "compressed": "gemm_core.dequant",
              "packed_b4": "gemm_core.unpack_dequant"}
    failures, seen, outs = [], Counter(), {}
    ops.reset_launch_counts()
    for mode, kw in WEIGHT_MODES.items():
        before = ops.launch_counts()
        t0 = time.perf_counter()
        toks, st, fails = _serve_full(torch, prompts, dict(kw, **prune))
        wall = time.perf_counter() - t0
        outs[mode] = toks
        delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
        for name, (got, _) in st["trace"].items():
            seen[name] += got
        f, shp = full[mode], st["shapes"]
        kv_ok = st["kv_bytes"] * cfg.n_kv_heads == f["kv_bytes"] * 6 \
            and shp.n_kv_heads == 6
        blk_want = (_predicted_block_bytes(cfg, shp, mode),
                    _predicted_block_bytes(cfg, LayerShapes.from_config(cfg),
                                           mode))
        blk_ok = (st["block_weight_bytes"], f["block_weight_bytes"]) == \
            blk_want and shp.d_ff == 5734
        epi = expect[mode].split(".")[1]
        ok = (not fails and kv_ok and blk_ok
              and abs(st["sparsity"] - PRUNE_SPARSITY) < 1e-3
              and len(toks) == len(PROMPT_LENS)
              and all(len(t) == GEN and t.min() >= 0 and t.max() < 92672
                      for t in toks.values())
              and delta[expect[mode]] > 0 and delta["decode_attn"] > 0
              and st["trace"][f"gemm_small_m.{epi}"][0] > 0)
        print(f"[8 pruned] {mode} at sparsity {st['sparsity']:.4f} (d_ff "
              f"{shp.d_ff}, {shp.n_heads} heads, {shp.n_kv_heads} of "
              f"{cfg.n_kv_heads} KV heads): decode "
              f"{st['decode_tok_per_s']:.1f} tok/s vs phase 5's "
              f"{f['decode_tok_per_s']:.1f} ({st['decode_tokens']} tokens, "
              f"{st['decode_steps']} steps), prefill "
              f"{st['prefill_tok_per_s']:.1f} vs "
              f"{f['prefill_tok_per_s']:.1f} tok/s; param_bytes "
              f"{st['param_bytes']} vs {f['param_bytes']} (x"
              f"{st['param_bytes'] / f['param_bytes']:.4f}; allocated "
              f"{st['param_alloc_bytes']}), block weights "
              f"{st['block_weight_bytes']} vs {f['block_weight_bytes']} (x"
              f"{st['block_weight_bytes'] / f['block_weight_bytes']:.4f}, "
              f"predicted from the widths {blk_want}) "
              f"{'ok' if blk_ok else 'FAIL'}, kv_bytes {st['kv_bytes']} vs "
              f"{f['kv_bytes']} (6/8: {'ok' if kv_ok else 'FAIL'}); host "
              f"launches {_nonzero(delta)}, wall {wall:.1f} s; "
              f"{_graph_line(st)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"pruned {mode}: {fails}")
    counts = ops.launch_counts()
    print(f"[8 pruned] main-path launch counts (host calls; a graph's calls "
          f"count once, at capture): {_nonzero(counts)}; the tensor-core "
          f"prefill copied x {counts['gemm_core.copies']} times (w_down's "
          f"rows of 5734 bf16 = 11468 bytes)")
    for name in [*expect.values(), "decode_attn", "fake_quant.fwd",
                 "gemm_core.small_m", "gemm_core.tc"]:
        if counts[name] <= 0:
            failures.append(f"{name} never launched on the pruned path")
    if counts["gemm_core.copies"] <= 0:
        failures.append("no x copy on the pruned prefill (w_down K 5734)")

    common = dict(max_slots=SLOTS, verbose=False, device="cuda", **prune)
    ref_int8 = engine_serve(ARCH, False, PROMPT_LENS, GEN, compressed=True,
                            bits_init=4.0, **common)
    same = _same(ref_int8, outs["packed_b4"])
    print(f"[8 pruned] packed 4-bit tokens "
          f"{'equal' if same else 'DIFFER FROM'} the int8 run's at the same "
          f"4-bit quantizer init {'ok' if same else 'FAIL'}")
    if not same:
        failures.append("pruned packed tokens differ from int8 tokens")
    for kv_bits in (None, 8):
        st: dict = {}
        out = engine_serve(ARCH, False, PROMPT_LENS, GEN, paged=True,
                           page_size=PAGE, kv_bits=kv_bits, stats=st,
                           **WEIGHT_MODES["packed_b4"], **common)
        full_len = all(len(t) == GEN for t in out.values())
        if kv_bits is None:
            ok = full_len and _same(out, outs["packed_b4"])
            what = "tokens " + ("equal" if ok else "DIFFER FROM") + \
                " the contiguous run's"
            bf16_pool = st["kv_pool_bytes"]
        else:
            first = all(out[r][0] == outs["packed_b4"][q][0]
                        for r, q in zip(sorted(out), sorted(outs["packed_b4"])))
            ok = full_len and first and st["kv_pool_bytes"] < bf16_pool
            what = (f"full-length outputs, first tokens "
                    f"{'equal' if first else 'DIFFER FROM'} the contiguous "
                    f"run's, pool {st['kv_pool_bytes']} B vs bf16 pages' "
                    f"{bf16_pool} B")
        print(f"[8 pruned] packed_b4 over {'int8' if kv_bits else 'bf16'} "
              f"pages: {what}; decode {st['decode_tok_per_s']:.1f} tok/s, "
              f"kv_bytes {st['kv_bytes']} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"pruned paged kv_bits={kv_bits}")

    # the masked reference: the same model served dense with the pruned
    # units multiplied by zero; bf16 sums over K = 8192 (zeros included)
    # and K = 5734 split differently, so the logits are held to a bound
    ref, lm = build_masked_reference_engine(
        ARCH, False, sparsity=PRUNE_SPARSITY, max_slots=SLOTS,
        max_seq=max(PROMPT_LENS) + GEN, device="cuda")
    want = _first_step_logits(torch, ref, prompts, GEN)
    ref.warmup()
    ref_toks = ref.run()
    del ref
    torch.cuda.empty_cache()
    from repro_torch.launch.engine import build_engine
    eng, _ = build_engine(ARCH, False, max_slots=SLOTS,
                          max_seq=max(PROMPT_LENS) + GEN, device="cuda",
                          **prune)
    got = _first_step_logits(torch, eng, prompts[:SLOTS], GEN)
    del eng
    torch.cuda.empty_cache()
    ok, line = _held_to_masked(torch, "dense, magnitude masks", got,
                               want[:SLOTS], outs["dense"], ref_toks)
    print(f"[8 pruned] {line}")
    if not ok:
        failures.append("pruned vs masked reference logits")
    failures += _geta_serving(torch, *geta)
    return counts, failures, dict(seen)


def _geta_serving(torch, params, qparams, keep) -> list[str]:
    """Phase 7's trained model through `construct_subnet` and into the
    engine: QASSO's keep masks (exactly k_units pruned) slice it, its
    learned bit widths become codes; one request of GETA_GEN tokens is
    served compressed, held to the masked reference (the trained params,
    whose pruned units QASSO already zeroed, with the masks multiplied
    in, served dense with the trained quantizers)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.qadg import build_qadg
    from repro_torch.core.subnet import construct_subnet, prepare_serving
    from repro_torch.launch.engine import Engine, synthetic_prompts
    from repro_torch.models.transformer import LM
    cfg = get_arch(ARCH)
    lm = LM(cfg)
    qadg = build_qadg(lm.build_graph().graph)
    t0 = time.perf_counter()
    sub = construct_subnet(qadg, params, qparams, keep)
    codes = sum(v.numel() * v.element_size()
                for v in sub.int_weights.values())
    dense = sum(sub.params[k].numel() * sub.params[k].element_size()
                for k in sub.int_weights)
    m = sub.meta
    print(f"[8 pruned] GETA: construct_subnet on phase 7's trained params "
          f"and QASSO's keep masks in {time.perf_counter() - t0:.2f} s: "
          f"sparsity {m['sparsity']:.4f}, {m['n_sites']} sites at mean "
          f"{m['mean_bits']:.3f} bits ({m['mean_storage_bits']:.2f} "
          f"storage), {len(sub.int_weights)} weights as codes: {codes} B "
          f"vs {dense} B as sliced dense weights (x{codes / dense:.4f})")
    failures = []
    if abs(m["sparsity"] - PRUNE_SPARSITY) > 1e-3:
        failures.append("GETA subnet sparsity")
    del sub
    torch.cuda.empty_cache()
    prompt = synthetic_prompts(cfg, [128], seed=3)
    p, q, meta = prepare_serving(lm, params, qparams, keep_masks=keep,
                                 compressed=True)
    eng = Engine(lm, p, q, max_slots=1, max_seq=128 + GETA_GEN)
    masked = qadg.space.apply_masks(params, keep)
    ref = Engine(LM(cfg), masked, qparams, max_slots=1,
                 max_seq=128 + GETA_GEN)
    logits, toks = [], []
    for e in (eng, ref):
        logits.append(_first_step_logits(torch, e, prompt, GETA_GEN))
        e.warmup()
        toks.append(e.run())
    ok, line = _held_to_masked(torch, "GETA, QASSO's masks, compressed",
                               logits[0], logits[1], toks[0], toks[1])
    full = all(len(t) == GETA_GEN for t in toks[0].values())
    print(f"[8 pruned] {line}; served {GETA_GEN} tokens at sparsity "
          f"{meta['sparsity']:.4f}, param_bytes {meta['param_bytes']}, "
          f"kv_bytes {eng.kv_bytes()} {'ok' if ok and full else 'FAIL'}")
    if not (ok and full):
        failures.append("GETA subnet vs masked reference")
    del eng, ref, masked, p
    torch.cuda.empty_cache()
    return failures


# ------------------------------------------------------------------ phase 9
SPEC_SPARSITY = 0.5         # the checkpoint pair's masks and draft
SPEC_K = 4                  # draft_k: rounds of k in {0, 1, 2, 4}
SPEC_DRAFTS = {"faithful": 8.0, "aggressive": 2.0}    # the draft's bits
SPEC_TARGETS = {"dense": False, "compressed": True}   # compressed= target
CHUNK = 128                 # chunked prefill: 96 -> 64+32, 200 -> 128+64+8
GAP_PROMPT = 512            # the prompt prefilled while a slot decodes
SPEC_TOL = 2 ** -5          # bf16 logits summed in another order
# the short workload's tokens per request (its three drains: graph, eager,
# traced): a traced round holds ~8500 kernels, and a trace of ~200k (24
# tokens, the aggressive draft) came back short on the H100
SPEC_TRACE_GEN = 6
GAP_TRIALS = 3


def _logits_held(torch, got, want) -> tuple[bool, str]:
    """`got` within SPEC_TOL of `want`'s range, with `want`'s argmax in
    every row unless its top-2 gap is within twice the difference."""
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    top2 = torch.topk(want, 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).min().item()
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    ok = diff <= SPEC_TOL * scale and (same or gap <= 2 * diff)
    return ok, (f"max|diff| {diff:.4f} of max|logit| {scale:.4f} "
                f"({diff / max(scale, 1e-30):.2e}, tol {SPEC_TOL}), argmax "
                f"{'equal' if same else 'DIFFERS'} (least top-2 gap "
                f"{gap:.4f})")


def _agreement(got: dict, want: dict) -> str:
    """Greedy-token agreement of two drains of the same requests and each
    request's first divergence (None: none)."""
    agree, first = [], []
    for r, q in zip(sorted(got), sorted(want)):
        n = min(len(got[r]), len(want[q]))
        eq = got[r][:n] == want[q][:n]
        agree.append(float(eq.mean()))
        first.append(int(np.argmin(eq)) if not eq.all() else None)
    return (f"tokens agree {np.mean(agree):.3f}, first divergences "
            f"{first}")


def _first_verify_logits(torch, eng, prompts, gen, k) -> "torch.Tensor":
    """Submit `prompts` to the speculative engine, admit, and run the
    first round's draft steps and verify pass by hand on the live arenas;
    return the verify logits of position 0 (the plain engine's first
    decode step's input), (slots, V) f32. The rows the pass wrote are
    rolled back, so the engine is as admission left it and may be warmed
    up and run."""
    from repro_torch.launch.speculative import rollback_rows
    for p in prompts:
        eng.submit(p, gen)
    eng._admit()
    eng._stage()
    tok, pos = eng._static["tok"], eng._static["pos"]
    d = eng.draft
    with torch.no_grad():
        t, p, props = tok, pos, []
        for _ in range(k + 1):
            lg, _ = d.lm.decode_step(eng._draft_params, eng._draft_qparams,
                                     eng.dcaches, t, p)
            t, p = lg[:, -1].argmax(-1)[:, None], p + 1
            props.append(t)
        chunk = torch.cat([tok] + props[:k], dim=1)
        logits, _ = eng.lm.verify_chunk(eng._run_params, eng._run_qparams,
                                        eng.caches, chunk, pos)
    rollback_rows(eng.caches, pos, pos + k)
    rollback_rows(eng.dcaches, pos, pos + k)
    return logits[:, 0].float()


def _never_drafted(torch, eng) -> bool:
    """Rows at and past every active slot's position are zero in both
    arenas (the contiguous ones: phase 9 checks its eager drains there)."""
    for slot, req in enumerate(eng.active):
        if req is None:
            continue
        pos = int(eng.pos[slot])
        for arena in (eng.caches, eng.dcaches):
            for c in arena.values():
                if torch.any(c[:, slot, pos:]):
                    return False
    return True


def _spec_line(eng, st) -> str:
    per_k = {k: round(1e3 * eng.spec_round_s[k] / n, 3)
             for k, n in sorted(eng.spec_rounds.items())}
    return (f"decode {st['decode_tok_per_s']:.1f} tok/s "
            f"({st['decode_tokens']} committed tokens in "
            f"{st['decode_s']:.3f} s, "
            f"{st['spec_steps']} rounds), acceptance "
            f"{st['acceptance_rate']:.3f} ({st['spec_accepted']}/"
            f"{st['spec_drafted']}), ms per round by k {per_k}, rounds by k "
            f"{dict(sorted(eng.spec_rounds.items()))}, capture "
            f"{st['capture_s']:.2f} s of {sorted(eng.graphs)}, graph "
            f"pool {eng.graph_pool_bytes / 2 ** 20:.1f} MiB, kv_bytes "
            f"{eng.kv_bytes()} (target {st['kv_target']} + draft "
            f"{st['kv_draft']}), peak {st['peak_bytes'] / 2 ** 30:.2f} GiB")


def _spec_engine(torch, target, draft, prompts, base_logits, base_toks,
                 **engine_kw) -> tuple[dict, dict, list[str]]:
    """One checkpoint pair's speculative engine at full width (see the
    module docstring): first-round verify logits against the plain
    engine's first step, warm-up (the round graphs), then graph rounds,
    eager rounds with the rollback invariant after each (contiguous
    only), and a short workload twice, untraced and under a profiler
    trace. Returns (tokens of the graph drain, stats, failures)."""
    from repro_torch.launch.speculative import build_checkpoint_engines
    failures = []
    spec, base, _ = build_checkpoint_engines(
        ARCH, False, sparsity=SPEC_SPARSITY, draft_bits=SPEC_DRAFTS[draft],
        draft_k=SPEC_K, max_slots=SLOTS, max_seq=max(PROMPT_LENS) + GEN,
        compressed=SPEC_TARGETS[target], device="cuda", **engine_kw)
    if base_logits is None:
        # the plain engine of the same target arrays, through phase 5's
        # graph windows
        base_logits = _first_step_logits(torch, base, prompts, GEN)
        base.warmup()
        base_toks = base.run()
        base_st = dict(base.stats, **base.throughput())
    else:
        base_st = None
    del base
    torch.cuda.empty_cache()
    if spec.paged:
        # its arenas are pools: the contiguous pair holds the logits
        for p in prompts:
            spec.submit(p, GEN)
        ok_logits, logit_line = True, "checked on the contiguous pair"
    else:
        got = _first_verify_logits(torch, spec, prompts, GEN, SPEC_K)
        ok_logits, logit_line = _logits_held(torch, got,
                                             base_logits[:SLOTS])
    torch.cuda.reset_peak_memory_stats()
    spec.warmup()
    captured = _CAPTURES[0]
    out = spec.run()
    st = dict(spec.stats, **spec.throughput(),
              kv_target=sum(c.numel() * c.element_size()
                            for c in spec.caches.values()),
              kv_draft=sum(c.numel() * c.element_size()
                           for c in spec.dcaches.values()),
              peak_bytes=torch.cuda.max_memory_allocated(),
              rounds=dict(spec.spec_rounds),
              round_s=dict(spec.spec_round_s),
              graph_pool_bytes=spec.graph_pool_bytes,
              replays=dict(spec.replays),
              graph_launches=spec.graph_launches)
    line = _spec_line(spec, st)
    full = (len(out) == len(prompts)
            and all(len(t) == GEN and t.min() >= 0 and t.max() < 92672
                    for t in out.values()))
    eager_ok = None
    if not spec.paged:
        # the first SLOTS requests, SPEC_TRACE_GEN tokens each, three
        # times: graph rounds, eager rounds, graph rounds under a trace
        for p in prompts[:SLOTS]:
            spec.submit(p, SPEC_TRACE_GEN)
        short = spec.run()
        for p in prompts[:SLOTS]:
            spec.submit(p, SPEC_TRACE_GEN)
        eager_ok = True
        while spec.pending:
            spec.eager_step()
            eager_ok = eager_ok and _never_drafted(torch, spec)
        eager = spec._drain(spec.eager_step)
        st["graph_eq_eager"] = _same(short, eager)
        if not (eager_ok and st["graph_eq_eager"]):
            failures.append("graph rounds differ from eager rounds, or the "
                            "rollback left rows past pos")
        traced, fam, st["traced_steps"], st["trace_takes"] = _trace_drain(
            torch, spec, prompts, f"speculative {target}/{draft}",
            spec=True, gen=SPEC_TRACE_GEN)
        st["trace"] = fam
        st["graph_eq_traced"] = _same(short, traced)
        for name, (seen, want) in fam.items():
            if seen != want:
                failures.append(f"trace: {seen} {name} kernels, {want} "
                                f"expected")
        if not st["graph_eq_traced"]:
            failures.append("a traced drain's tokens differ from an "
                            "untraced drain's")
    if _CAPTURES[0] != captured:
        failures.append("a CUDA graph was captured inside a drain")
    if sorted(spec.graphs) != spec._spec_ks():
        failures.append("warmup() did not capture every draft length")
    for k in (2, 4):
        if spec.graph_launches[k].get("gemm_core.tc", 0) <= 0:
            failures.append(f"the k={k} verify took no tensor-core GEMM")
    if not (full and ok_logits):
        failures.append(f"outputs or first-round logits ({logit_line})")
    agree = _agreement(out, base_toks)
    kind = "paged " if spec.paged else ""
    checks = "" if eager_ok is None else (
        f"; {SLOTS} requests x {SPEC_TRACE_GEN} tokens in graph rounds == "
        f"in eager rounds {'yes' if st['graph_eq_eager'] else 'NO'} "
        f"(rollback invariant after every eager round "
        f"{'held' if eager_ok else 'BROKEN'}) == in traced graph rounds "
        f"{'yes' if st['graph_eq_traced'] else 'NO'} (trace taken "
        f"{st['trace_takes']}x; kernels "
        f"(seen, expected) "
        + ", ".join(f"{k} {v[0]}/{v[1]}" for k, v in st["trace"].items())
        + ")")
    print(f"[9 speculative] {kind}{target} target, {draft} draft "
          f"(s{100 * SPEC_SPARSITY:.0f}/b{SPEC_DRAFTS[draft]:.0f}, k "
          f"{SPEC_K}): {line}; first-round verify logits vs the plain "
          f"engine's first step: {logit_line}; vs the plain engine: "
          f"{agree}{checks} {'ok' if not failures else 'FAIL'}")
    st["base_logits"], st["base_toks"], st["base_stats"] = \
        base_logits, base_toks, base_st
    del spec
    torch.cuda.empty_cache()
    return out, st, failures


def _chunked_logits(torch, eng, prompt) -> tuple["torch.Tensor", ...]:
    """The first generated token's logits of `prompt` through the
    engine's chunked prefill (`verify_chunk` over `chunk_plan`) and
    through its one-shot prefill, f32, on fresh rows."""
    from repro_torch.launch.scheduler import chunk_plan
    toks = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")[None]
    with torch.no_grad():
        row, done = eng._fresh_row(), 0
        for c in chunk_plan(len(prompt), CHUNK):
            lg, _ = eng.lm.verify_chunk(eng._run_params, eng._run_qparams,
                                        row, toks[:, done:done + c], done,
                                        last_logit_only=True)
            done += c
        one, _ = eng.lm.prefill(eng._run_params, eng._run_qparams,
                                eng._fresh_row(), toks, last_logit_only=True)
    return lg[0, -1].float(), one[0, -1].float()


def _decode_gaps(torch, eng, chunked: bool) -> list[float]:
    """The longest interval (ms, host clock) between two decode steps of
    a slot that decodes while a GAP_PROMPT-token prompt arrives and is
    prefilled, in each of GAP_TRIALS runs: one-step decodes replaying the
    captured one-step window, the prompt prefilled one-shot at admission,
    or chunk by chunk between the steps."""
    from repro_torch.launch.engine import synthetic_prompts
    short, long_ = synthetic_prompts(eng.lm.cfg, [32, GAP_PROMPT], seed=5)
    real = eng._commit
    eng.submit(short, GEN)
    eng.warmup()
    eng.run()
    gaps = []
    for _ in range(GAP_TRIALS):
        stamps = []

        def commit(toks):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            real(toks)

        eng._commit = commit
        eng.submit(short, GEN)
        steps = 0
        while eng.pending:
            if steps == 8:
                eng.submit(long_, 8)
            if chunked:
                eng.step()
            else:
                eng._admit()
                if eng.n_active:
                    eng._stage()
                    eng._commit(eng._replay(1))
            steps += 1
        del eng._commit
        eng.run()
        gaps.append(1e3 * max(b - a for a, b in zip(stamps, stamps[1:])))
    return gaps


def phase_spec(torch, full: dict, one_shot: dict
               ) -> tuple[dict, list[str], dict, dict]:
    """Phase 9 (see the module docstring). `full`: phase 5's stats per
    mode; `one_shot`: phase 5's tokens per mode. Returns the launch
    counts of the phase, its failures, its trace families summed and the
    speculative engines' stats."""
    from collections import Counter
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import (WEIGHT_MODES, build_engine,
                                           synthetic_prompts)
    cfg = get_arch(ARCH)
    prompts = synthetic_prompts(cfg, PROMPT_LENS, seed=0)
    failures, seen, stats = [], Counter(), {}
    ops.reset_launch_counts()
    outs = {}
    for target in SPEC_TARGETS:
        base_logits = base_toks = None
        for draft in SPEC_DRAFTS:
            t0 = time.perf_counter()
            out, st, fails = _spec_engine(torch, target, draft, prompts,
                                          base_logits, base_toks)
            base_logits, base_toks = st["base_logits"], st["base_toks"]
            if st["base_stats"] is not None:
                b = st["base_stats"]
                print(f"[9 speculative] {target} target, plain engine "
                      f"(graph windows): decode {b['decode_tok_per_s']:.1f} "
                      f"tok/s ({b['decode_tokens']} tokens in "
                      f"{b['decode_s']:.3f} s)")
            print(f"[9 speculative] {target}/{draft}: wall "
                  f"{time.perf_counter() - t0:.1f} s")
            outs[target, draft] = out
            stats[target, draft] = st
            failures += [f"spec {target}/{draft}: {f}" for f in fails]
            for name, (got, _) in st.get("trace", {}).items():
                seen[name] += got
        acc = {d: stats[target, d]["acceptance_rate"] for d in SPEC_DRAFTS}
        ok = acc["faithful"] > acc["aggressive"]
        print(f"[9 speculative] {target} target: acceptance faithful "
              f"{acc['faithful']:.3f} vs aggressive {acc['aggressive']:.3f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{target}: faithful acceptance not above "
                            f"aggressive")
    replays = Counter()
    for st in stats.values():
        replays.update(st["replays"])
    for k in (2, 4):
        if replays[k] <= 0:
            failures.append(f"no round of draft length {k} (verify M = "
                            f"{SLOTS * (k + 1)}) replayed")
    # the faithful dense pair over pages
    for kv_bits in (None, 8):
        out, st, fails = _spec_engine(
            torch, "dense", "faithful", prompts,
            stats["dense", "faithful"]["base_logits"],
            stats["dense", "faithful"]["base_toks"], paged=True,
            page_size=PAGE, kv_bits=kv_bits)
        want = outs["dense", "faithful"]
        if kv_bits is None:
            ok = _same(out, want)
            what = "tokens " + ("equal" if ok else "DIFFER FROM") + \
                " the contiguous pair's"
        else:
            ok = all(len(t) == GEN for t in out.values()) and all(
                out[r][0] == want[q][0]
                for r, q in zip(sorted(out), sorted(want)))
            what = ("full-length outputs, first tokens "
                    + ("equal" if ok else "DIFFER FROM")
                    + " the contiguous pair's")
        print(f"[9 speculative] paged dense/faithful over "
              f"{'int8' if kv_bits else 'bf16'} pages: {what} "
              f"{'ok' if ok and not fails else 'FAIL'}")
        if not ok or fails:
            failures.append(f"paged spec kv_bits={kv_bits}: {fails}")
    # chunked prefill: logits of the first token, tokens against phase 5's
    # one-shot engines, prefill rate, and the decode gap
    for mode in ("dense", "packed_b4"):
        for paged in (False, True):
            kw = dict(WEIGHT_MODES[mode], max_slots=SLOTS,
                      max_seq=max(PROMPT_LENS) + GEN, device="cuda",
                      prefill_chunk=CHUNK)
            if paged:
                kw.update(paged=True, page_size=PAGE)
            eng, _ = build_engine(ARCH, False, **kw)
            lg, one = _chunked_logits(torch, eng, prompts[5])
            ok_l, logit_line = _logits_held(torch, lg[None], one[None])
            for p in prompts:
                eng.submit(p, GEN)
            captured = _CAPTURES[0]
            eng.warmup()
            out = eng.run()
            st = dict(eng.stats, **eng.throughput())
            ok = (ok_l and _CAPTURES[0] == captured + 1
                  and sorted(eng.graphs) == [1]
                  and all(len(t) == GEN for t in out.values())
                  and st["chunked_prefills"] == len(prompts))
            print(f"[9 chunked] {mode}, {'paged' if paged else 'contiguous'}"
                  f", chunk {CHUNK}: first token's logits, chunked prefill "
                  f"of {len(prompts[5])} tokens vs one-shot: {logit_line}; "
                  f"vs phase 5's one-shot engine: "
                  f"{_agreement(out, one_shot[mode])}; prefill "
                  f"{st['prefill_tok_per_s']:.1f} tok/s vs phase 5's "
                  f"{full[mode]['prefill_tok_per_s']:.1f} "
                  f"({st['prefill_chunks']} chunks), decode "
                  f"{st['decode_tok_per_s']:.1f} tok/s "
                  f"({st['decode_steps_mid_prefill']} steps mid-prefill) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"chunked {mode} paged={paged}")
            if mode == "dense" and not paged:
                gap_c = _decode_gaps(torch, eng, chunked=True)
            del eng
            torch.cuda.empty_cache()
    eng, _ = build_engine(ARCH, False, max_slots=SLOTS,
                          max_seq=max(PROMPT_LENS) + GEN, device="cuda")
    gap_o = _decode_gaps(torch, eng, chunked=False)
    del eng
    torch.cuda.empty_cache()
    print(f"[9 chunked] longest gap between two decode steps of a slot "
          f"while a {GAP_PROMPT}-token prompt is prefilled (dense, one-step "
          f"graph decodes; {GAP_TRIALS} runs each): chunked ({CHUNK}) "
          f"{[round(g, 2) for g in gap_c]} ms, one-shot "
          f"{[round(g, 2) for g in gap_o]} ms")
    counts = ops.launch_counts()
    print(f"[9 speculative] phase launch counts (host calls; a graph's "
          f"calls count once, at capture): {_nonzero(counts)}")
    for name in ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
                 "gemm_core.unpack_dequant", "gemm_core.small_m",
                 "gemm_core.tc", "decode_attn", "paged_decode_attn.bf16"):
        if counts[name] <= 0:
            failures.append(f"{name} never launched in phase 9")
    return counts, failures, dict(seen), stats


LONG_PROMPT = 4096     # past attn_block_threshold: attention_blockwise
LONG_GEN = 8


def phase_long(torch) -> list[str]:
    """Phase 4's full-width long-sequence checks (see the module
    docstring): a 4096-token prompt through `attention_blockwise`, and one
    loss-and-gradient pass at 1 x 4096."""
    from repro_torch.configs import get_arch
    from repro_torch.core.subnet import prepare_serving
    from repro_torch.launch import train as T
    from repro_torch.launch.engine import Engine, synthetic_prompts
    from repro_torch.models import layers
    from repro_torch.models.transformer import LM
    failures = []
    calls = [0]
    blockwise = layers.attention_blockwise

    def counted(*a, **kw):
        calls[0] += 1
        return blockwise(*a, **kw)

    # the attention itself at the model's shapes, f32, against the dense
    gen = torch.Generator(device="cuda").manual_seed(4)
    cfg = get_arch(ARCH)
    q = torch.randn((1, LONG_PROMPT, cfg.n_heads, cfg.d_head), generator=gen,
                    device="cuda")
    k, v = (torch.randn((1, LONG_PROMPT, cfg.n_kv_heads, cfg.d_head),
                        generator=gen, device="cuda") for _ in range(2))
    got = blockwise(q, k, v, block=cfg.attn_block_size)
    want = layers.attention_dense(q, k, v)
    err = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
    print(f"[4 correctness] attention_blockwise f32 at S={LONG_PROMPT}, "
          f"block {cfg.attn_block_size}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV, dh {cfg.d_head} vs attention_dense: "
          f"max|diff| {err:.2e} (rtol 1e-5, atol 1e-5) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("attention_blockwise vs dense on the card")
    del q, k, v, got, want

    # a 4096-token prompt prefilled through attention_blockwise (bf16,
    # compressed weights), against the same prefill through the dense
    # attention, then served by the engine for LONG_GEN tokens
    lm = LM(cfg)
    params, qparams, _ = prepare_serving(
        lm, lm.init(torch.Generator(device="cuda").manual_seed(0)),
        compressed=True)
    prompt = synthetic_prompts(cfg, [LONG_PROMPT], seed=2)[0]
    toks = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")[None]
    layers.attention_blockwise = counted
    try:
        cache = lm.init_cache(1, LONG_PROMPT, dtype=torch.bfloat16,
                              device="cuda")
        blk, _ = lm.prefill(params, qparams, cache, toks, last_logit_only=True)
    finally:
        layers.attention_blockwise = blockwise
    dense_lm = LM(dataclasses.replace(cfg, attn_block_threshold=LONG_PROMPT))
    cache = lm.init_cache(1, LONG_PROMPT, dtype=torch.bfloat16, device="cuda")
    dense, _ = dense_lm.prefill(params, qparams, cache, toks,
                                last_logit_only=True)
    del cache
    a, b = blk[0, -1].float(), dense[0, -1].float()
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    top2 = torch.topk(b, 2).values
    gap = (top2[0] - top2[1]).item()
    # bf16 activations: the two attentions sum in another order, so a bf16
    # rounding of their outputs flips now and then and moves through 24
    # layers; 2^-5 of the logit range, as the prefill-vs-decode check; the
    # argmax must agree unless the top-2 gap is within twice the diff
    same_argmax = int(a.argmax()) == int(b.argmax()) or gap <= 2 * diff
    ok = (calls[0] == cfg.n_layers and diff <= scale / 32 and same_argmax
          and bool(torch.isfinite(blk).all()))
    print(f"[4 correctness] {LONG_PROMPT}-token prompt, full width "
          f"compressed: attention_blockwise calls {calls[0]} (one per "
          f"layer), last-position logits vs the dense attention's "
          f"max|diff| {diff:.4f} max|logit| {scale:.4f} (tol "
          f"{scale / 32:.4f}), argmax {int(a.argmax())} vs "
          f"{int(b.argmax())} (top-2 gap {gap:.4f}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("4096-token blockwise prefill")
    eng = Engine(lm, params, qparams, max_slots=1,
                 max_seq=LONG_PROMPT + LONG_GEN)
    rid = eng.submit(prompt, LONG_GEN)
    eng.warmup()
    out = eng.run()[rid]
    ok = (len(out) == LONG_GEN and out[0] == int(a.argmax())
          and 0 <= out.min() and out.max() < cfg.vocab_padded
          and sum(eng.replays.values()) > 0)
    print(f"[4 correctness] the {LONG_PROMPT}-token prompt served by the "
          f"engine: {len(out)} tokens {out.tolist()}, first = the blockwise "
          f"prefill's argmax, windows {dict(eng.replays)} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("4096-token prompt through the engine")
    del eng, params, qparams, blk, dense
    torch.cuda.empty_cache()

    # one loss-and-gradient pass at 1 x 4096 (fake-quant training path)
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    qparams = lm.init_qparams(params, bits_init=16.0)
    batch = T.batch_for(cfg, 0, 0, 1, LONG_PROMPT, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls[0] = 0
    layers.attention_blockwise = counted
    t0 = time.perf_counter()
    try:
        loss, gx, gq = T.loss_and_grads(lm, params, qparams, batch)
        torch.cuda.synchronize()
    finally:
        layers.attention_blockwise = blockwise
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = (bool(torch.isfinite(loss))
              and all(bool(torch.isfinite(g).all()) for g in gx.values())
              and all(bool(torch.isfinite(t).all()) for q in gq.values()
                      for t in (q.d, q.q_m, q.t)))
    # the forward and, under remat, its recompute in the backward
    want_calls = cfg.n_layers * (1 + int(cfg.remat))
    ok = finite and calls[0] == want_calls
    print(f"[4 correctness] loss and gradients at 1 x {LONG_PROMPT}, full "
          f"width bf16, 16-bit quantizers: loss {float(loss):.4f}, every "
          f"gradient finite {finite}, attention_blockwise calls {calls[0]} "
          f"(expected {want_calls}), wall {wall:.2f} s, peak memory "
          f"{peak:.2f} GiB {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("1 x 4096 loss and gradients")
    del params, qparams, gx, gq, batch
    torch.cuda.empty_cache()
    return failures


# every stage in 5 steps
COMP5 = dict(target_sparsity=0.3, warmup_steps=1, projection_periods=1,
             projection_steps=1, pruning_periods=2, pruning_steps=1,
             cooldown_steps=1)
COLMASK = ("attn.wq", "attn.wk", "attn.wv", "mlp.w_gate", "mlp.w_up")


def predicted_train_launches(lm, qasso, stages, f32_inputs=()) -> dict:
    """Kernel launches of `train_loop` steps in `stages`: per step every
    routed projection (P of them) runs the fake_quant_rhs GEMM forward,
    again in the remat recompute, and for dx; its dwq runs with no
    epilogue; the fake-quant backward runs per projection and once for
    the head, whose forward quantizes once per step; a joint step also
    fake-quantizes each weight site's stacked tensor once (Alg 2 line
    18). No call splits K (M >= 2048), and every GEMM takes the
    tensor-core variant (bf16 x): `tc` counts them all, `simt` none; but
    the projections named by a suffix in `f32_inputs` take an f32 x, so
    their GEMMs (all four) take the SIMT variant, counted under `simt`,
    after a copy of each transposed operand (`copies`)."""
    names = [n for n in lm.quant_weight_names() if n.startswith("blocks.")]
    P = lm.n_blocks * len(names)
    F = lm.n_blocks * sum(n.endswith(f32_inputs) for n in names) \
        if f32_inputs else 0
    passes = 2 + int(lm.cfg.remat)
    n = len(stages)
    out = {"gemm_core.fake_quant_rhs": passes * P * n,
           "gemm_core.none": P * n,
           "gemm_core.tc": (passes + 1) * (P - F) * n,
           "fake_quant.bwd": (P + 1) * n,
           "fake_quant.fwd": n + len(qasso.weight_sites) * sum(
               s == 2 for s in stages)}
    if f32_inputs:
        # the SIMT variant reads x and w row-major: dx's w.T and dwq's
        # x.T are copied first
        out["gemm_core.simt"] = (passes + 1) * F * n
        out["gemm_core.copies"] = 2 * F * n
    return out


def predicted_colmask_launches(lm) -> dict:
    """One loss-and-gradient pass with `.colmask` on COLMASK's projections
    (C per layer of 7), with quantizers, then without; every GEMM on the
    tensor-core variant."""
    L, C = lm.n_blocks, len(COLMASK)
    fwd = 1 + int(lm.cfg.remat)
    gemms = {"gemm_core.fq_col_mask": C * L * fwd,
             "gemm_core.fake_quant_rhs": (7 - C) * L * fwd + 7 * L,
             "gemm_core.none": 7 * L + C * L,
             "gemm_core.col_mask": C * L * (fwd + 1)}
    return {**gemms, "gemm_core.tc": sum(gemms.values()),
            "fake_quant.bwd": 7 * L + 1, "fake_quant.fwd": 1}


def _colmask_params(torch, params, gen) -> tuple[dict, dict, dict]:
    """Three param dicts for COLMASK's stacked projections (L, K, N):
    `<name>.colmask` seeded random (L, N) masks that keep about 70% of the
    output columns; the masked columns zeroed in the weight, with all-ones
    `.colmask`s; and the masked columns zeroed, with no `.colmask`."""
    masked, ones, zeroed = dict(params), dict(params), dict(params)
    for k, w in params.items():
        if k.endswith(COLMASK) and w.ndim == 3:
            m = (torch.rand((w.shape[0], w.shape[2]), generator=gen,
                            device=w.device) > 0.3).float()
            masked[k + ".colmask"] = m
            zeroed[k] = ones[k] = w * m[:, None, :].to(w.dtype)
            ones[k + ".colmask"] = torch.ones_like(m)
    return masked, ones, zeroed


def _bitwise(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a, b)


def phase_train(torch) -> tuple[dict, dict, list[str], tuple]:
    """Phase 7 (see the module docstring). Returns (launch counts of
    `train_loop`, launch counts of the `.colmask` step, failures, the
    final params, quantizers and QASSO keep masks)."""
    from repro_torch.configs import CompressionConfig, get_arch
    from repro_torch.core.quant import bit_width
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models.transformer import LM
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
        return "ok" if ok else "FAIL"

    torch.use_deterministic_algorithms(True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    hist = []
    t0 = time.perf_counter()
    state, qadg, qasso, losses = T.train_loop(
        ARCH, False, 5, TRAIN_BATCH, TRAIN_SEQ, seed=0,
        comp=CompressionConfig(**COMP5), verbose=False, device="cuda",
        history=hist)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lm_cfg = get_arch(ARCH)
    lm = LM(lm_cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, h in enumerate(hist):
        print(f"[7 train] step {i} stage {h['stage']} loss {h['loss']:.4f} "
              f"bits [{h['bits_min']:.2f}, {h['bits_max']:.2f}] sparsity "
              f"{h['sparsity_hard']:.4f} wall {h['wall_s']:.3f} s "
              f"{tokens / h['wall_s']:.1f} tok/s")
    stages = [h["stage"] for h in hist]
    keep = state["qstate"].keep_mask
    n_pruned = sum(int(torch.sum(v < 0.5)) for v in keep.values())
    b_l, b_u = qasso.cfg.bit_lower, qasso.cfg.bit_upper_final
    bits = [float(bit_width(q.d, q.q_m, q.t))
            for q in state["qparams"].values()]
    elem_keep = qasso._keep_elem_tree(state["params"], keep)
    nonzero_pruned = sum(int(torch.count_nonzero(
        p * (1.0 - elem_keep[k]).to(p.dtype)))
        for k, p in state["params"].items())
    print(f"[7 train] internlm2-1.8b full width bf16, batch "
          f"{TRAIN_BATCH}x{TRAIN_SEQ}, 5 steps in {wall:.2f} s, stages "
          f"{stages} {check(stages == [0, 1, 2, 2, 3], 'stage order')}, "
          f"losses finite "
          f"{check(all(math.isfinite(x) for x in losses), 'finite loss')}, "
          f"pruned units {n_pruned} of {qasso.total_units} (k_units "
          f"{qasso.k_units}) {check(n_pruned == qasso.k_units, 'sparsity')}"
          f", nonzero pruned elements {nonzero_pruned} "
          f"{check(nonzero_pruned == 0, 'pruned units zero')}, bits "
          f"[{min(bits):.3f}, {max(bits):.3f}] in [{b_l}, {b_u}] "
          f"{check(b_l - 1e-3 <= min(bits) and max(bits) <= b_u + 1e-3, 'bits')}"
          f", peak memory {peak:.2f} GiB "
          f"{check(peak < 60 * 1e9 / 2 ** 30, 'peak memory < 60 GB')}")
    want = predicted_train_launches(lm, qasso, stages)
    got = {k: counts[k] for k in want}
    others = {k: v for k, v in counts.items() if v and k not in want}
    print(f"[7 train] launches {got} predicted {want} "
          f"{check(got == want and not others, 'train launch counts')}"
          + (f" unexpected {others}" if others else "")
          + f"; every GEMM on the tensor-core variant: tc "
          f"{counts['gemm_core.tc']}, simt {counts['gemm_core.simt']}, "
          f"small_m {counts['gemm_core.small_m']} "
          f"{check(counts['gemm_core.simt'] == 0, 'train GEMMs on tc')}")

    # one loss-and-gradient pass with .colmask params, quantized and not,
    # its launches counted from 0 on their own
    params, qparams = state["params"], state["qparams"]
    geta = (params, qparams, keep)       # phase 8 serves the trained subnet
    del state
    torch.cuda.empty_cache()
    batch = T.batch_for(lm_cfg, 0, 5, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    masked, ones, zeroed = _colmask_params(
        torch, params, torch.Generator(device="cuda").manual_seed(7))
    ops.reset_launch_counts()
    loss_q, gx, _ = T.loss_and_grads(lm, masked, qparams, batch)
    del gx
    loss_p, gx, _ = T.loss_and_grads(lm, masked, None, batch)
    del gx
    colmask_counts = _nonzero(ops.launch_counts())
    want_c = predicted_colmask_launches(lm)
    with torch.no_grad():
        ref_q = lm.loss(zeroed, qparams, batch)     # fake_quant_rhs on w*m
        ref_p = lm.loss(ones, None, batch)          # col_mask on w*m, m = 1
        lib_p = lm.loss(zeroed, None, batch)        # torch.matmul on w*m
        unmasked = lm.loss(params, qparams, batch)
    rel = abs(float(loss_p) - float(lib_p)) / abs(float(lib_p))
    moved = not torch.equal(unmasked, ref_q)
    print(f"[7 train] .colmask step, random masks keeping ~70% of the "
          f"columns: loss with quantizers {float(loss_q):.6f} vs zeroed "
          f"columns {float(ref_q):.6f} "
          f"{check(torch.equal(loss_q, ref_q), 'colmask loss bitwise')} "
          f"(bitwise; unmasked {float(unmasked):.6f}, masks move the loss "
          f"{check(moved, 'colmask masks move the loss')}); without "
          f"quantizers {float(loss_p):.6f} vs zeroed columns under an "
          f"all-ones mask {float(ref_p):.6f} "
          f"{check(torch.equal(loss_p, ref_p), 'colmask plain loss bitwise')}"
          f" (bitwise) and vs the torch.matmul path {float(lib_p):.6f} (rel "
          f"{rel:.1e}, tol 1e-3) {check(rel < 1e-3, 'colmask plain loss')}; "
          f"launches {colmask_counts} predicted {want_c} "
          f"{check(colmask_counts == want_c, 'colmask launch counts')}")
    del masked, ones, zeroed, batch
    torch.cuda.empty_cache()

    # two runs of a joint step 0 from one seeded state
    runs = []
    for _ in range(2):
        lm2, p, q, _, qa, s = T.init_geta(ARCH, False, seed=0, device="cuda",
                                          comp=T.JOINT_STEP0)
        b = T.batch_for(lm2.cfg, 0, 0, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
        p, q, s, m = T.make_geta_train_step(lm2, qa)(p, q, s, b)
        runs.append((p, q, s.redundant, s.keep_mask, m["loss"]))
        del s, b
        torch.cuda.empty_cache()
    (p0, q0, r0, k0, l0), (p1, q1, r1, k1, l1) = runs
    same = (all(_bitwise(torch, p0[k], p1[k]) for k in p0)
            and all(_bitwise(torch, getattr(q0[k], f), getattr(q1[k], f))
                    for k in q0 for f in ("d", "q_m", "t"))
            and all(_bitwise(torch, r0[k], r1[k])
                    and _bitwise(torch, k0[k], k1[k]) for k in r0)
            and _bitwise(torch, l0, l1))
    print(f"[7 train] two runs of a joint step 0 from one state: params, "
          f"quantizers, masks and loss {'bitwise equal' if same else 'DIFFER'}"
          f" {check(same, 'train step reproducible')}")
    del runs, p0, p1, q0, q1
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)

    # the smoke config's joint step (f32: its GEMMs take the SIMT
    # variant), card against the CPU plain versions
    ops.reset_launch_counts()
    runs = T.step_on_devices(ARCH, ["cpu", "cuda"])
    simt = ops.launch_counts()["gemm_core.simt"]
    diff = T.step_differences(runs["cpu"], runs["cuda"])
    tol = T.STEP_TOLERANCES
    ok = diff["masks"] and all(diff[k] <= v for k, v in tol.items())
    print(f"[7 train] smoke config joint step, card vs CPU: masks "
          f"{'identical' if diff['masks'] else 'DIFFER'}, "
          + ", ".join(f"{k} {diff[k]:.1e} (tol {v:.0e})"
                      for k, v in tol.items())
          + f" {check(ok, 'smoke step card vs cpu')}; its GEMMs on the "
          f"SIMT variant {simt} times "
          f"{check(simt > 0, 'smoke step on the SIMT variant')}")

    # the same step with activation quantizers (each activation site
    # through the fake-quant kernels): masks and loss held, the rest
    # reported, since a rounding tie of an activation that the GEMMs'
    # summation order flips moves the step's params and quantizers
    comp = dataclasses.replace(T.JOINT_STEP0, act_quant=True)
    before = ops.launch_counts()["fake_quant.fwd"]
    runs = T.step_on_devices(ARCH, ["cpu", "cuda"], comp=comp)
    fwd = ops.launch_counts()["fake_quant.fwd"] - before
    n_act = sum(k.endswith(".aq") for k in runs["cuda"][1])
    diff = T.step_differences(runs["cpu"], runs["cuda"])
    ok = diff["masks"] and diff["loss"] <= tol["loss"] and fwd >= n_act > 0
    print(f"[7 train] smoke config joint step with act_quant ({n_act} "
          f"activation sites, {fwd} fake_quant.fwd launches), card vs CPU: "
          f"masks {'identical' if diff['masks'] else 'DIFFER'}, loss "
          f"{diff['loss']:.1e} (tol {tol['loss']:.0e}) "
          f"{check(ok, 'act_quant smoke step card vs cpu')}; reported: "
          + ", ".join(f"{k} {diff[k]:.1e}" for k in (
              "params", "d", "q_m", "t", "act_d", "act_q_m", "act_t")))
    return counts, colmask_counts, failures, geta


# ----------------------------------------------------------------- phase 10
RUN_LAYERS = 4          # phase 10's depth cut: 4 of 24 layers, widths full
RUN_STEPS, RUN_EVERY, RUN_FAIL = 8, 5, 7
# every stage in 8 steps: warm-up 1, projection 1 x 1, pruning 2 x 2,
# cool-down 2; the checkpoint at 5 holds the state after the first pruning
# period, and the replay of steps 5-6 crosses from the last joint step
# (which hard-zeroes G_R and freezes the keep mask) into cool-down
COMP8 = dict(target_sparsity=0.3, warmup_steps=1, projection_periods=1,
             projection_steps=1, pruning_periods=2, pruning_steps=2,
             cooldown_steps=2)


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _same_tree(torch, a, b) -> bool:
    """Two state trees equal leaf for leaf: structure, types, dtypes,
    devices and bits."""
    from repro_torch.checkpoint.checkpoint import tree_flatten
    (la, sa), (lb, sb) = tree_flatten(a), tree_flatten(b)
    return sa == sb and all(
        (type(x) is type(y) and x.dtype == y.dtype and x.device == y.device
         and torch.equal(x, y)) if isinstance(x, torch.Tensor)
        else (type(x) is type(y) and x == y) for x, y in zip(la, lb))


def phase_run_loop(torch) -> tuple[dict, list]:
    """Phase 10 (see the module docstring). Returns the killed run's
    launch counts and the failures."""
    import shutil
    import tempfile
    from repro_torch.configs import CompressionConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models.transformer import LM
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
        return "ok" if ok else "FAIL"

    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    runs = {}
    try:
        for label, kw in (("clean", {}), ("killed", dict(
                ckpt_dir=tmp, checkpoint_every=RUN_EVERY,
                inject_failure_at=RUN_FAIL))):
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            hist, report = [], {}
            t0 = time.perf_counter()
            state, _, qasso, losses = T.train_loop(
                ARCH, False, RUN_STEPS, batch, seq, seed=0,
                comp=CompressionConfig(**COMP8), verbose=False,
                device="cuda", history=hist, report=report,
                layers=RUN_LAYERS, **kw)
            runs[label] = dict(
                state=state, qasso=qasso, losses=losses, hist=hist,
                report=report, counts=ops.launch_counts(),
                wall=time.perf_counter() - t0,
                peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        runs["killed"]["bytes"] = _dir_bytes(Path(tmp) / f"step_{RUN_EVERY}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
    clean, killed = runs["clean"], runs["killed"]
    cfg = get_arch(ARCH)
    lm = LM(dataclasses.replace(cfg, n_layers=RUN_LAYERS))
    stages = [h["stage"] for h in clean["hist"]]
    k_stages = [h["stage"] for h in killed["hist"]]
    result = killed["report"]["run_result"]
    tokens = batch * seq
    print(f"[10 run loop] internlm2-1.8b at full width (d_model "
          f"{lm.cfg.d_model}, d_ff {lm.cfg.d_ff}, vocab {lm.cfg.vocab}), "
          f"depth cut to {lm.cfg.n_layers} of {cfg.n_layers} layers, "
          f"{lm.cfg.dtype}, batch {batch}x{seq}, {RUN_STEPS} steps, "
          f"checkpoint every {RUN_EVERY}, a failure injected at step "
          f"{RUN_FAIL}")
    for i, h in enumerate(clean["hist"]):
        print(f"[10 run loop] clean step {i} stage {h['stage']} loss "
              f"{h['loss']:.6f} wall {h['wall_s']:.3f} s "
              f"{tokens / h['wall_s']:.1f} tok/s")
    same = _same_tree(torch, clean["state"], killed["state"])
    replay = clean["losses"][:RUN_FAIL] + clean["losses"][RUN_EVERY:]
    want_stages = stages[:RUN_FAIL] + stages[RUN_EVERY:]
    print(f"[10 run loop] killed run: {len(killed['losses'])} losses (want "
          f"{RUN_STEPS + RUN_FAIL - RUN_EVERY}), each the clean run's at its "
          f"step {check(killed['losses'] == replay, 'replayed losses')}; "
          f"restarts {result.restarts} "
          f"{check(result.restarts == 1, 'one restart')}; stages {stages}, "
          f"killed {k_stages} "
          f"{check(stages == [0, 1, 2, 2, 2, 2, 3, 3] and k_stages == want_stages, 'run loop stages')}"
          f"; final trees (params, quantizers, the QASSO state with its int "
          f"counters, rng) {'bitwise equal' if same else 'DIFFER'} "
          f"{check(same, 'killed run bitwise the clean run')}; losses finite "
          f"{check(all(math.isfinite(x) for x in clean['losses']), 'finite run-loop loss')}")
    save_s = killed["report"]["save_s"]
    restore_s = killed["report"]["restore_s"]
    walls = ", ".join(f"{h['wall_s']:.3f}" for h in clean["hist"][5:])
    print(f"[10 run loop] checkpoint at step {RUN_EVERY}: "
          f"{killed['bytes']} bytes ({killed['bytes'] / 2 ** 30:.2f} GiB); "
          f"save {', '.join(f'{s:.3f}' for s in save_s)} s, restore "
          f"{', '.join(f'{s:.3f}' for s in restore_s)} s "
          f"{check(len(save_s) == 1 and len(restore_s) == 1, 'one save, one restore')}"
          f"; clean step walls past step 5: {walls} s; runs {clean['wall']:.1f}"
          f" s clean, {killed['wall']:.1f} s killed; peak memory "
          f"{clean['peak']:.2f} GiB clean, {killed['peak']:.2f} GiB killed")
    for label, stg in (("clean", stages), ("killed", k_stages)):
        want = predicted_train_launches(lm, runs[label]["qasso"], stg)
        counts = runs[label]["counts"]
        got = {k: counts[k] for k in want}
        others = {k: v for k, v in counts.items() if v and k not in want}
        ok = got == want and not others
        print(f"[10 run loop] {label} run launches {got} predicted {want} "
              f"{check(ok, f'{label} run-loop launch counts')}"
              + (f" unexpected {others}" if others else ""))
    return killed["counts"], failures


# ----------------------------------------------------------------- phase 11
# the paper's substrates: every stage in 6 steps (warm-up 1, projection
# 2 x 1, pruning 2 x 1, cool-down 1) under `benchmarks/geta_experiments.py`'s
# choices (bits [4, 16], b_r 2, Adam, lr_quant 1e-3)
SUB_SCHED = dict(target_sparsity=0.35, bit_lower=4.0, bit_upper=16.0,
                 warmup_steps=1, projection_periods=2, projection_steps=1,
                 bit_reduction=2.0, pruning_periods=2, pruning_steps=1,
                 cooldown_steps=1, base_optimizer="adam", lr_quant=1e-3)
SUB_STAGES = [0, 1, 1, 2, 2, 3]
CNN_BATCH = 64
BERT_BATCH, BERT_SEQ = 16, 64


def substrates() -> list[dict]:
    """Phase 11's models at the JAX package's full specs: VGG7 with weight
    and activation quantizers (Table 4), ResNet20 with weight quantizers
    (Table 2), the BERT encoder at its defaults (Table 3's harness)."""
    from repro_torch.data.synthetic import image_batch, qa_batch
    from repro_torch.models import bert, cnn
    enc = bert.BertEncoder()

    def images(i):
        return image_batch(0, i, CNN_BATCH, device="cuda")

    return [dict(name=cnn.VGG7.name, model=cnn.CNN(cnn.VGG7), act_quant=True,
                 bits=16.0, lr=3e-3, unit="images", per_step=CNN_BATCH,
                 batch=images),
            dict(name=cnn.RESNET20.name, model=cnn.CNN(cnn.RESNET20),
                 act_quant=False, bits=16.0, lr=3e-3, unit="images",
                 per_step=CNN_BATCH, batch=images),
            dict(name="bert", model=enc, act_quant=False, bits=8.0, lr=2e-3,
                 unit="tokens", per_step=BERT_BATCH * BERT_SEQ,
                 batch=lambda i: qa_batch(0, i, BERT_BATCH, BERT_SEQ, enc.V,
                                          device="cuda"))]


def predicted_substrate_launches(qasso, stages, act_sites: int) -> dict:
    """Fake-quant launches of a substrate's steps: every weight site and
    every activation site its forward quantizes once forward and once
    backward; a joint step also fake-quantizes each weight site's params
    once (Alg 2 line 18). Convolutions and products are plain PyTorch: no
    GEMM kernel."""
    sites = len(qasso.weight_sites) + act_sites
    joint = sum(s == 2 for s in stages) * sum(
        len(s.quantized_params) for s in qasso.weight_sites)
    return {"fake_quant.fwd": sites * len(stages) + joint,
            "fake_quant.bwd": sites * len(stages)}


def _tally_fq_shapes(tally: dict):
    """Count the fake-quant wrappers' launches by "kernel shape" until
    the returned function is called: each call adds the difference of its
    wrapper's own count across the call."""
    from repro_torch.kernels import fake_quant as fq
    orig = {fq.FWD: fq.fake_quant_fwd, fq.BWD: fq.fake_quant_bwd}

    def wrap(direction):
        def call(x, *args):
            before = fq.launches[direction]
            out = orig[direction](x, *args)
            key = f"fake_quant.{direction} {'x'.join(map(str, x.shape))}"
            tally[key] = tally.get(key, 0) + fq.launches[direction] - before
            return out
        return call

    fq.fake_quant_fwd, fq.fake_quant_bwd = wrap(fq.FWD), wrap(fq.BWD)

    def restore():
        fq.fake_quant_fwd, fq.fake_quant_bwd = orig[fq.FWD], orig[fq.BWD]
    return restore


def phase_substrates(torch) -> tuple[dict, list]:
    """Phase 11 (see the module docstring). Returns, per model, the
    fake-quant launch counts and, under "by_shape", those launches by
    kernel and shape; and the failures."""
    from repro_torch.checkpoint import clone_tree
    from repro_torch.core.bops import model_bops
    from repro_torch.core.qadg import build_qadg
    from repro_torch.core.qasso import QASSO, QASSOConfig
    from repro_torch.core.quant import bit_width
    from repro_torch.core.subnet import construct_subnet
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.optim.schedules import constant
    failures, out = [], {}

    def check(ok, what):
        if not ok:
            failures.append(what)
        return "ok" if ok else "FAIL"

    torch.use_deterministic_algorithms(True)
    try:
        for sub in substrates():
            m, name = sub["model"], sub["name"]
            torch.cuda.reset_peak_memory_stats()
            params = m.init(torch.Generator(device="cuda").manual_seed(0))
            qparams = m.init_qparams(params, bits_init=sub["bits"],
                                     act_quant=sub["act_quant"])
            qadg = build_qadg(m.build_graph(act_quant=sub["act_quant"])
                              .graph)
            qadg.space.validate(params)
            qasso = QASSO(qadg.space, qadg.sites, QASSOConfig(**SUB_SCHED),
                          constant(sub["lr"]))
            state = qasso.init(params, qparams)
            step = T.make_geta_train_step(m, qasso)
            stages, losses, walls, snap, by_shape = [], [], [], None, {}
            ops.reset_launch_counts()
            restore = _tally_fq_shapes(by_shape)
            for i in range(qasso.cfg.total_steps):
                b = sub["batch"](i)
                if qasso.stage_index(i) == 2 and snap is None:
                    snap = (clone_tree(params), clone_tree(qparams),
                            clone_tree(state), b)
                t0 = time.perf_counter()
                params, qparams, state, met = step(params, qparams, state, b)
                losses.append(float(met["loss"]))         # syncs the device
                walls.append(time.perf_counter() - t0)
                stages.append(met["stage"])
            restore()
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            # two runs of the first joint step from one state
            reps = [step(*clone_tree(snap[:3]), snap[3]) for _ in range(2)]
            (p0, q0, s0, m0), (p1, q1, s1, m1) = reps
            same = (_same_tree(torch, (p0, q0, s0.redundant, s0.keep_mask),
                               (p1, q1, s1.redundant, s1.keep_mask))
                    and torch.equal(m0["loss"], m1["loss"]))
            del reps, snap
            keep = state.keep_mask
            n_pruned = sum(int(torch.sum(v < 0.5)) for v in keep.values())
            elem_keep = qasso._keep_elem_tree(params, keep)
            nonzero = sum(int(torch.count_nonzero(
                p * (1.0 - elem_keep[k]).to(p.dtype)))
                for k, p in params.items())
            b_l, b_u = qasso.cfg.bit_lower, qasso.cfg.bit_upper_final
            bits = [float(bit_width(q.d, q.q_m, q.t))
                    for q in qparams.values()]
            act = sum(s.kind == "act" for s in qadg.sites)
            want = predicted_substrate_launches(qasso, stages, act)
            got = {k: counts[k] for k in want}
            gemm = {k: v for k, v in counts.items()
                    if k.startswith("gemm_core") and v}
            sn = construct_subnet(qadg, params, qparams, keep)
            macs = (m.layer_macs(BERT_BATCH, BERT_SEQ) if name == "bert"
                    else m.layer_macs(batch=1))
            bops = model_bops(qadg, params, qparams, macs, masks=keep)
            wall = statistics.median(walls)
            out[name] = dict(got, by_shape=by_shape)
            print(f"[11 substrates] {name}: {len(qadg.sites)} sites ({act} "
                  f"activation), {qasso.total_units} units, stages {stages} "
                  f"{check(stages == SUB_STAGES, f'{name} stages')}, losses "
                  f"{', '.join(f'{x:.4f}' for x in losses)} finite "
                  f"{check(all(math.isfinite(x) for x in losses), f'{name} finite loss')}"
                  f", pruned units {n_pruned} (k_units {qasso.k_units}) "
                  f"{check(n_pruned == qasso.k_units, f'{name} sparsity')}, "
                  f"nonzero pruned elements {nonzero} "
                  f"{check(nonzero == 0, f'{name} pruned units zero')}, bits "
                  f"[{min(bits):.3f}, {max(bits):.3f}] in [{b_l}, {b_u}] "
                  f"{check(b_l - 1e-3 <= min(bits) and max(bits) <= b_u + 1e-3, f'{name} bits')}"
                  f", two runs of a joint step from one state "
                  f"{'bitwise equal' if same else 'DIFFER'} "
                  f"{check(same, f'{name} step reproducible')}")
            tallied = {k: sum(v for key, v in by_shape.items()
                              if key.split()[0] == k) for k in want}
            at = {key: v for key, v in by_shape.items()
                  if key.split()[1] in {"x".join(map(str, sh))
                                        for sh in CNN_FQ_SHAPES.values()}}
            print(f"[11 substrates] {name}: launches {got} predicted {want} "
                  f"{check(got == want, f'{name} fake-quant launches')}, "
                  f"by shape {tallied} "
                  f"{check(tallied == got, f'{name} launches by shape')}"
                  + (f" ({at} at phase 3's CNN shapes)" if at else "") +
                  f", GEMM kernels {gemm or 'none'} "
                  f"{check(not gemm, f'{name} launched a GEMM kernel')}; "
                  f"construct_subnet sparsity {sn.meta['sparsity']:.4f} mean "
                  f"bits {sn.meta['mean_bits']:.3f}; rel_bops "
                  f"{bops['rel_bops']:.5f}; step wall median {wall:.4f} s "
                  f"({', '.join(f'{w:.4f}' for w in walls)}), "
                  f"{sub['per_step'] / wall:.1f} {sub['unit']}/s; peak "
                  f"memory {peak:.2f} GiB")
            del params, qparams, state, step
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return out, failures


MOE_ARCH = "grok-1-314b"
MOE_LAYERS = 2             # phase 12's depth cut: 2 of 64 layers, widths full
MOE_TRAIN_LAYERS = 1       # 12d: 1 layer, batch 2 x 256, 16-bit init
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 256
MOE_PEAK = 70e9            # the phase's device-memory budget, bytes
MOE_SPARSITY = 0.5         # 12b and the draft of 12c: 8 -> 4 experts
MOE_PROMPT = 32            # 12a's prefill-vs-decode prompt
MOE_TRACE_STEPS = 16       # 12a's traced decode window
# phase 3's rows at grok-1's shapes: (M, K, N) of wq / wo, wk / wv and the
# head at decode (M = 4 slots), and wq at a 512-token prefill
# (the head runs a GEMM kernel only from codes: dense, it is prequantized
# once and multiplied by torch.matmul), with their launches per decode step
# (per 512-token prefill for M = 512) at MOE_LAYERS layers
MOE_GEMMS = [(4, 6144, 6144, ("fake_quant_rhs", "dequant"), 2 * MOE_LAYERS),
             (4, 6144, 1024, ("fake_quant_rhs", "dequant"), 2 * MOE_LAYERS),
             (4, 6144, 131072, ("dequant",), 1),
             (512, 6144, 6144, ("fake_quant_rhs", "dequant"), 2 * MOE_LAYERS)]
MOE_DECODE = (SLOTS, DECODE_S, 8, 6, 128)      # B, S, KVh, g, dh
# the expert stacks the fake-quant kernels take: phase 12a's engine
# (2 layers, past 2^31 elements) and 12d's training pass (1 layer)
MOE_STACKS = {"experts_l2": (2, 8, 6144, 32768),
              "experts_l1": (1, 8, 6144, 32768)}
PLAIN_CHUNK = 1 << 27      # elements per chunk of a plain version's pass


def _moe_cfg(layers: int):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(MOE_ARCH), n_layers=layers)


def moe_reckoning(cfg) -> dict:
    """Phase 12's bytes from the config alone (bf16 weights, f32 norms):
    the params, the
    expert stacks, the embed and the head, the engine's fake-quanted copy
    of the stacks and the head (`Engine.__init__` splits the quantizers
    once), and KV bytes per token."""
    D, V, F, E = cfg.d_model, cfg.vocab_padded, cfg.d_ff, cfg.moe.n_experts
    attn = 2 * D * cfg.q_dim + 2 * D * cfg.kv_dim
    experts = 3 * E * D * F
    L = cfg.n_layers
    bf16 = 2 * V * D + L * (attn + experts + D * E)
    norms = (2 * L + 1) * D                       # f32
    return {"params": bf16 + norms, "attn_per_layer": attn,
            "experts_per_layer": experts, "embed": V * D,
            "param_bytes": 2 * bf16 + 4 * norms,
            "expert_bytes": 2 * L * experts,
            "fq_copy_bytes": 2 * (L * (experts + D * E) + V * D),
            "kv_bytes_per_token": 2 * 2 * L * cfg.n_kv_heads * cfg.d_head}


def _gemm_shape_tally(gc, tally):
    """Wrap `gc.gemm` so that each CUDA call adds one to tally[(variant,
    epilogue, K, N)]; returns the unwrapped function (restore it after)."""
    real = gc.gemm

    def tallied(x, w, epi, **kw):
        out = real(x, w, epi, **kw)
        if x.is_cuda:
            key = (gc.variant(x.shape[0], x.dtype), epi.name, x.shape[-1],
                   w.shape[-1])
            tally[key] += 1
        return out

    tallied.launches = real.launches
    gc.gemm = tallied
    return real


def _moe_gemm_rows(torch, timer, gen) -> tuple[list, dict, list]:
    """Phase 3's GEMM and decode-attention rows at grok-1's shapes."""
    import itertools
    from repro_torch.kernels import gemm_core as gc
    rows, report, failures = [], {}, []
    for M, K, N, epis, _ in MOE_GEMMS:
        x = torch.randn((M, K), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        for label, w, epi, dequantized in itertools.islice(
                _gemm_cases(torch, K, N, gen), 2):
            if label not in epis:
                continue
            row = _gemm_row(torch, timer, gc, label, x, w, epi,
                            dequantized(), tag=" (grok-1)")
            rows.append(row)
            if not row["ok"]:
                failures.append(row)
            report[f"{_report_name(label)}.grok.M{M}.{K}x{N}"] = row
        del x
        torch.cuda.empty_cache()
    B, S, KVh, g, dh = MOE_DECODE
    pos = torch.tensor(DECODE_POS[:B], dtype=torch.int64, device="cuda")
    row = _decode_check(torch, timer, gen, B, S, KVh, g, dh, pos)
    rows.append(row)
    if not row["ok"]:
        failures.append(row)
    report["decode_attn.grok"] = row
    return rows, report, failures


def _chunks(t, n: int = PLAIN_CHUNK):
    flat = t.reshape(-1)
    return [flat[i:i + n] for i in range(0, flat.numel(), n)]


def _plain_fwd_chunked(torch, x, sc):
    """The plain fake-quant forward over x in PLAIN_CHUNK pieces (the whole
    tensor's f32 temporaries would not fit), into one output."""
    from repro_torch.kernels import ref
    y = torch.empty_like(x)
    for yc, xc in zip(_chunks(y), _chunks(x)):
        yc.copy_(ref.fake_quant_fwd_ref(xc, *sc))
    return y


def _plain_bwd_chunked(torch, x, sc, g):
    """The plain fake-quant backward in PLAIN_CHUNK pieces: dx, and the
    three sums as f64 sums of the pieces' f32 sums."""
    from repro_torch.kernels import ref
    dx = torch.empty_like(x)
    sums = [0.0, 0.0, 0.0]
    for dc, xc, gc_ in zip(_chunks(dx), _chunks(x), _chunks(g)):
        d, *s = ref.fake_quant_bwd_ref(xc, *sc, gc_)
        dc.copy_(d)
        sums = [a + float(b) for a, b in zip(sums, s)]
    return dx, sums


def _fq_bwd_against_plain(torch, x, sc, g, got) -> dict:
    """A fake-quant backward's result `got` on (x, g) against the plain
    version, piece by piece: dx bitwise, each sum within 1e-5 of its
    `sum_scales` bound (computed over 256-row blocks of the last axis)."""
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels import ref
    dx_same, err, sums = True, 0.0, [0.0, 0.0, 0.0]
    for dc, xc, gc_ in zip(_chunks(got[0]), _chunks(x), _chunks(g)):
        d, *s = ref.fake_quant_bwd_ref(xc, *sc, gc_)
        dx_same = dx_same and torch.equal(dc, d)
        err = max(err, (dc.float() - d.float()).abs().max().item())
        sums = [a + float(b) for a, b in zip(sums, s)]
        del d
    last = x.shape[-1]
    scales = fq.sum_scales(x.reshape(-1, last), g.reshape(-1, last), *sc)
    serr = [abs(float(a) - b) / max(s, 1e-30)
            for a, b, s in zip(got[1:], sums, scales)]
    return {"dx_bitwise": dx_same, "max_abs_err": err,
            "sum_err_over_scale": serr, "ok": dx_same and max(serr) <= 1e-5}


def _moe_fq_rows(torch, timer, gen) -> tuple[list, dict, list]:
    """Phase 3's fake-quant rows on the expert stacks (bf16, the 16-bit
    init of 12d, t = 1): the kernels against their plain versions piece by
    piece (forward bitwise; backward dx bitwise, sums within 1e-5 of
    `sum_scales`, a second call bitwise), times, bounds, kernels per
    call."""
    from repro_torch.core.quant import init_quant_params
    from repro_torch.kernels import fake_quant as fq
    rows, report, failures = [], {}, []
    for label, shape in MOE_STACKS.items():
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16).mul_(shape[-2] ** -0.5)
        qp = init_quant_params(x, bits=16.0)
        sc = (qp.d, qp.q_m, qp.t)
        n = x.numel()
        y = fq.fake_quant_fwd(x, *sc)
        bitwise, err = True, 0.0
        for xc, yc in zip(_chunks(x), _chunks(y)):
            want = _plain_fwd_chunked(torch, xc, sc)
            bitwise = bitwise and torch.equal(yc, want)
            err = max(err, (yc.float() - want.float()).abs().max().item())
            del want
        del y
        row = {"kernel": "fake_quant.fwd", "w": label, "shape": shape,
               "t": 1.0, "numel": n, "past_2_31": n > 2 ** 31,
               "max_abs_err": err, "bitwise": bitwise, "ok": bitwise,
               "library_ms": None,
               "ms": timer(lambda: fq.fake_quant_fwd(x, *sc)),
               "plain_ms": timer(lambda: _plain_fwd_chunked(torch, x, sc))}
        row["bound_ms"], row["bound_by"] = bound_ms(fq.fwd_bytes(x), 0)
        _one_kernel(torch, row, lambda: fq.fake_quant_fwd(x, *sc))
        g = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16).mul_(1e-3)
        got = fq.fake_quant_bwd(x, *sc, g)
        again = fq.fake_quant_bwd(x, *sc, g)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        brow = {"kernel": "fake_quant.bwd", "w": label, "shape": shape,
                "t": 1.0, "numel": n, "past_2_31": n > 2 ** 31,
                "repeat_bitwise": repeat, "library_ms": None,
                "bwd_rows": fq.bwd_rows(n),
                **_fq_bwd_against_plain(torch, x, sc, g, got)}
        del got
        brow["ok"] = brow["ok"] and repeat
        brow["ms"] = timer(lambda: fq.fake_quant_bwd(x, *sc, g))
        brow["plain_ms"] = timer(lambda: _plain_bwd_chunked(torch, x, sc, g))
        brow["bound_ms"], brow["bound_by"] = bound_ms(fq.bwd_bytes(x, g), 0)
        _one_kernel(torch, brow, lambda: fq.fake_quant_bwd(x, *sc, g))
        for r in (row, brow):
            print(f"[3 kernels] {r['kernel']:<29} {label} "
                  f"{'x'.join(map(str, shape))} bf16 ({n} elements) t=1 "
                  f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} (in "
                  f"pieces of {PLAIN_CHUNK}) library_ms=none "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
                  + (f" bitwise={r['bitwise']}" if "bitwise" in r else
                     f" dx_bitwise={r['dx_bitwise']} sums/scale="
                     f"{max(r['sum_err_over_scale']):.1e} repeat_bitwise="
                     f"{r['repeat_bitwise']} rows={r['bwd_rows']}")
                  + f"{_per_call(r)} {'ok' if r['ok'] else 'FAIL'}")
            rows.append(r)
            if not r["ok"]:
                failures.append(r)
            report[f"{r['kernel']}.{label}"] = r
        del x, g
        torch.cuda.empty_cache()
    return rows, report, failures


def phase_moe_kernels(torch, timer) -> tuple[list, dict, list]:
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows, report, failures = _moe_gemm_rows(torch, timer, gen)
    r2, rep2, f2 = _moe_fq_rows(torch, timer, gen)
    report.update(rep2)
    return rows + r2, report, failures + f2


def _expert_ms(torch, events) -> float:
    """Device ms of the library (cuBLAS) GEMM kernels among `events`: the
    MoE's expert and router products (and, when the head is served dense,
    its product); the port's own kernels excluded."""
    from repro_torch.launch.profile_decode import _union_ms
    ours = ("gemm_small_m", "gemm_tc", "gemm_general", "flash_decode",
            "fq_")
    lib = [e for e in events
           if not any(o in e.name for o in ours)
           and any(t in e.name.lower() for t in ("gemm", "xmma", "nvjet",
                                                 "cutlass", "sm90_"))]
    return _union_ms(lib)


def _moe_window_trace(torch, eng, prompts, prompt=MOE_PROMPT,
                      steps=MOE_TRACE_STEPS) -> dict:
    """Admit SLOTS requests of `prompt` tokens, then one window of `steps`
    decode steps (a graph replay) under a profiler trace: per step the
    host wall, the device busy time (union of the kernels' intervals), the
    idle share, the library (cuBLAS) products' device ms (`expert_ms`:
    the MoE's expert and router products, the dense head), the small-M
    GEMM kernels' ms and the glue's (every kernel that is neither a GEMM
    nor decode attention: the recurrent scans, norms, routing) ms and
    kernel count."""
    from repro_torch.launch.profile_decode import _union_ms
    for p in prompts:
        eng.submit(p[:prompt], steps + 1)
    eng._admit()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(TRACE_WARMUP):
            warm.fill_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._window()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted((e for e in prof.events() if e.device_type == cuda),
                    key=lambda e: e.time_range.start)
    # the window's kernels start after the fill kernels that open the
    # trace (which the host synchronized before the window)
    fills = [e.time_range.end for e in events[:TRACE_WARMUP]
             if "fill" in e.name.lower()]
    if fills:
        events = [e for e in events if e.time_range.start >= max(fills)]
    eng.run()
    busy = _union_ms(events) / steps
    small = [e for e in events if "gemm_small_m" in e.name]
    lib_ms = _expert_ms(torch, events)
    glue = [e for e in events if not any(
        t in e.name.lower() for t in ("gemm", "xmma", "nvjet", "cutlass",
                                      "sm90_", "flash_decode"))]
    return {"wall_ms": wall / steps, "busy_ms": busy,
            "idle_share": 1.0 - busy / (wall / steps),
            "expert_ms": lib_ms / steps,
            "small_m_ms": _union_ms(small) / steps,
            "glue_ms": _union_ms(glue) / steps,
            "glue_kernels": len(glue) / steps,
            "kernels_per_step": len(events) / steps}


def _moe_serve(torch, lm, p, q, prompts, label, eager_gen=None,
               **kw) -> tuple:
    """One engine at full width over phase 5's traffic: warm-up (the
    window graphs), a graph drain (the measurement), an eager drain of the
    same requests (bitwise the graph drain's). With `eager_gen` (phase
    13), the warm-up runs before the requests are queued (it captures the
    graphs and prefills nothing: a recurrent prefill has no shape to set
    up and costs ~0.3 ms a token of host time), and the eager drain
    serves only the SLOTS requests with the shortest prompts,
    `eager_gen` tokens each, held to the graph drain's first tokens of
    those requests (a slot's row computes the same in any batch, which
    the solo drains of `_solo` check). Returns (engine, tokens, stats,
    failures)."""
    from repro_torch.launch.engine import Engine
    eng = Engine(lm, p, q, max_slots=SLOTS,
                 max_seq=max(PROMPT_LENS) + GEN, **kw)
    if eager_gen is not None:
        eng.warmup()
    for pr in prompts:
        eng.submit(pr, GEN)
    if eager_gen is None:
        eng.warmup()
    captured = _CAPTURES[0]
    out = eng.run()
    st = dict(eng.stats, **eng.throughput(), kv_bytes=eng.kv_bytes(),
              kv_pool_bytes=eng.kv_pool_bytes(),
              param_bytes=eng.param_bytes())
    if eager_gen is None:
        for pr in prompts:
            eng.submit(pr, GEN)
        want = out
    else:
        short = sorted(sorted(range(len(prompts)),
                              key=lambda i: len(prompts[i]))[:SLOTS])
        for i in short:
            eng.submit(prompts[i], eager_gen)
        order = sorted(out)
        want = {order[i]: out[order[i]][:eager_gen] for i in short}
    eager = eng._drain(eng.step)
    failures = []
    st["graph_eq_eager"] = _same(want, eager)
    if not st["graph_eq_eager"]:
        failures.append(f"{label}: graph-window tokens differ from eager "
                        f"steps")
    if _CAPTURES[0] != captured:
        failures.append(f"{label}: a CUDA graph was captured inside run()")
    V = lm.cfg.vocab
    if not (len(out) == len(prompts) and all(
            len(t) == GEN and t.min() >= 0 and t.max() < V
            for t in out.values())):
        failures.append(f"{label}: outputs missing or out of range")
    return eng, out, st, failures


def _prefill_vs_decode(torch, eng, prompt) -> tuple[bool, str]:
    """The full-capacity prefill's last logits of one prompt against as
    many eager decode steps from an empty row (`_logits_held`)."""
    lm = eng.lm
    with torch.no_grad():
        toks = torch.as_tensor(prompt[None], dtype=torch.int64,
                               device="cuda")
        row = lm.init_cache(1, toks.shape[1], dtype=torch.bfloat16,
                            device="cuda")
        want, _ = lm.prefill(eng._run_params, eng._run_qparams, row, toks,
                             last_logit_only=True)
        row = lm.init_cache(1, toks.shape[1], dtype=torch.bfloat16,
                            device="cuda")
        for i in range(toks.shape[1]):
            got, _ = lm.decode_step(eng._run_params, eng._run_qparams, row,
                                    toks[:, i:i + 1], i)
    return _logits_held(torch, got[:, -1].float(), want[:, -1].float())


def phase_moe(torch) -> tuple[dict, dict, list[str], dict]:
    """Phase 12 (see the module docstring). Returns the launch counts of
    its engines (12a-c), the GEMM launches by (variant, epilogue, K, N),
    the failures and the stats printed."""
    from collections import Counter
    from repro_torch.core.subnet import prepare_serving, tree_bytes
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import fake_quant as fq
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Engine, synthetic_prompts
    from repro_torch.launch.speculative import DraftModel
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.transformer import LM
    t_start = time.perf_counter()
    failures, info = [], {}
    cfg = _moe_cfg(MOE_LAYERS)
    rk = moe_reckoning(cfg)
    full = moe_reckoning(_moe_cfg(64))
    resident = rk["param_bytes"] + rk["fq_copy_bytes"]
    print(f"[12 moe] {MOE_ARCH} at its published widths (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, d_head "
          f"{cfg.d_head}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16), depth cut to "
          f"{MOE_LAYERS} of 64 layers; reckoned: embed and head 2 x "
          f"{rk['embed'] / 1e6:.1f}M params, {rk['attn_per_layer'] / 1e6:.1f}M "
          f"attention and {rk['experts_per_layer'] / 1e9:.3f}e9 expert params "
          f"a layer, {rk['params'] / 1e9:.2f}e9 params "
          f"({rk['param_bytes'] / 1e9:.1f} GB; the 64-layer model "
          f"{full['param_bytes'] / 1e9:.0f} GB), the engine's fake-quanted "
          f"copy {rk['fq_copy_bytes'] / 1e9:.1f} GB, resident "
          f"{resident / 1e9:.1f} GB, KV {rk['kv_bytes_per_token']} bytes a "
          f"token")
    prompts = synthetic_prompts(cfg, PROMPT_LENS, seed=0)
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg)
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    measured = tree_bytes(params)
    if measured != rk["param_bytes"]:
        failures.append(f"param bytes {measured} != reckoned "
                        f"{rk['param_bytes']}")
    ops.reset_launch_counts()
    tally, fq_shapes = Counter(), Counter()
    real = _gemm_shape_tally(gc, tally)
    real_fwd = fq.fake_quant_fwd

    def fwd_by_shape(x, d, q_m, t):
        fq_shapes[("fwd", tuple(x.shape))] += 1
        return real_fwd(x, d, q_m, t)

    fq.fake_quant_fwd = fwd_by_shape
    try:
        # ---- 12a: the engine in two weight modes over both arenas
        toks, traces = {}, {}
        for mode in ("dense", "compressed"):
            p, q, meta = prepare_serving(lm, params,
                                         compressed=(mode == "compressed"))
            if mode == "compressed":
                dense_experts = all(
                    f"blocks.0.moe.{w}" in p
                    and f"blocks.0.moe.{w}.codes" not in p
                    and f"blocks.0.moe.{w}.wq" in q
                    for w in ("router", "we_gate", "we_up", "we_down"))
                if not dense_experts or "head.codes" not in p:
                    failures.append("int8 mode: expert stacks not dense "
                                    "with their fake-quant sites, or the "
                                    "head not in codes")
                info["skipped_sites"] = meta["skipped_sites"]
            for arena in ("contiguous", "paged"):
                label = f"{mode}/{arena}"
                kw = dict(paged=True, page_size=PAGE) if arena == "paged" \
                    else {}
                t0 = time.perf_counter()
                eng, out, st, fails = _moe_serve(torch, lm, p, q, prompts,
                                                 label, **kw)
                failures += fails
                extra = ""
                if arena == "contiguous":
                    toks[mode] = out
                    traces[mode] = tr = _moe_window_trace(torch, eng,
                                                          prompts[:SLOTS])
                    # dense, the prequantized head is a library product too
                    lib_bytes = rk["expert_bytes"] + (
                        2 * rk["embed"] if mode == "dense" else 0)
                    bound = 1e3 * lib_bytes / HBM_BYTES_PER_S
                    tr["lib_bound_ms"] = bound
                    extra = (f"; a traced {MOE_TRACE_STEPS}-step window: "
                             f"step wall {tr['wall_ms']:.3f} ms, busy "
                             f"{tr['busy_ms']:.3f} ms, idle share "
                             f"{tr['idle_share']:.3f}, "
                             f"{tr['kernels_per_step']:.0f} kernels a step, "
                             f"library products (cuBLAS: experts, router"
                             f"{', head' if mode == 'dense' else ''}) "
                             f"{tr['expert_ms']:.3f} ms a step against their "
                             f"byte bound {bound:.3f} ms "
                             f"({lib_bytes / 1e9:.1f} GB at 3.35 TB/s)")
                    if mode == "dense":
                        ok, line = _prefill_vs_decode(
                            torch, eng, prompts[PROMPT_LENS.index(32)])
                        extra += (f"; {MOE_PROMPT}-token full-capacity "
                                  f"prefill's last logits vs {MOE_PROMPT} "
                                  f"eager decode steps: {line}")
                        if not ok:
                            failures.append("prefill vs decode: " + line)
                else:
                    same = _same(out, toks[mode])
                    extra = (f"; tokens {'equal' if same else 'DIFFER FROM'}"
                             f" the contiguous arena's")
                    if not same:
                        failures.append(f"{label}: paged tokens differ from "
                                        f"contiguous tokens")
                print(f"[12a moe engine] {label}: decode "
                      f"{st['decode_tok_per_s']:.1f} tok/s "
                      f"({st['decode_tokens']} tokens, "
                      f"{st['decode_steps']} steps in "
                      f"{st['decode_s']:.3f} s), prefill "
                      f"{st['prefill_tok_per_s']:.1f} tok/s, param_bytes "
                      f"{st['param_bytes']}, kv_bytes {st['kv_bytes']}, "
                      f"graphs {sorted(eng.graphs)} in "
                      f"{st['capture_s']:.2f} s, graph tokens "
                      f"{'==' if st['graph_eq_eager'] else '!='} eager "
                      f"step tokens, peak "
                      f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
                      f"wall {time.perf_counter() - t0:.1f} s{extra}")
                del eng
                torch.cuda.empty_cache()
            del p, q
            torch.cuda.empty_cache()
        info["traces"] = traces
        agree = _agreement(toks["compressed"], toks["dense"])
        print(f"[12a moe engine] int8 vs dense fake-quant tokens: {agree}")

        # ---- 12b: pruned at sparsity 0.5 with the expert floor
        slim = LM(cfg)
        p, q, meta = prepare_serving(slim, params,
                                     prune_sparsity=MOE_SPARSITY)
        shp = slim.shapes[0]
        kept = shp.n_experts
        dense_exp = sum(tree_bytes({k: v}) for k, v in params.items()
                        if ".moe.we_" in k)
        sliced_exp = sum(tree_bytes({k: v}) for k, v in p.items()
                         if ".moe.we_" in k)
        eng, out, st, fails = _moe_serve(torch, slim, p, q, prompts,
                                         "pruned")
        failures += fails
        full_kv = LM(cfg).init_cache(SLOTS, max(PROMPT_LENS) + GEN,
                                     device="meta")
        kv_want = tree_bytes(full_kv) * shp.n_kv_heads // cfg.n_kv_heads
        ok = (cfg.moe.top_k <= kept < cfg.moe.n_experts
              and sliced_exp * cfg.moe.n_experts == dense_exp * kept
              and st["kv_bytes"] == kv_want)
        if not ok:
            failures.append(f"pruned: experts {kept}, expert bytes "
                            f"{sliced_exp} of {dense_exp}, kv "
                            f"{st['kv_bytes']} (want {kv_want})")
        print(f"[12b moe pruned] sparsity {MOE_SPARSITY} with the expert "
              f"floor (top_k {cfg.moe.top_k}): realized "
              f"{meta['sparsity']:.3f}, experts {cfg.moe.n_experts} -> "
              f"{kept}, KV heads {cfg.n_kv_heads} -> {shp.n_kv_heads}; "
              f"expert bytes {sliced_exp} = {kept}/{cfg.moe.n_experts} of "
              f"{dense_exp}; kv_bytes {st['kv_bytes']} (want {kv_want}); "
              f"decode {st['decode_tok_per_s']:.1f} tok/s; graph tokens "
              f"{'==' if st['graph_eq_eager'] else '!='} eager step tokens; "
              f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
              f"{'ok' if ok and not fails else 'FAIL'}")
        del eng, p, q, slim
        torch.cuda.empty_cache()

        # ---- 12c: speculative, a dense target with its s50 b8 MoE draft
        half = rk["expert_bytes"] // 2
        spec_reckoned = resident + 2 * half + 5e9
        spec_layers = MOE_LAYERS if spec_reckoned <= MOE_PEAK else 1
        scfg, sparams, slm = cfg, params, lm
        if spec_layers != MOE_LAYERS:
            del params
            torch.cuda.empty_cache()
            scfg = _moe_cfg(spec_layers)
            slm = LM(scfg)
            sparams = slm.init(torch.Generator(device="cuda").manual_seed(0))
        dlm = LM(scfg)
        dp, dq, dmeta = prepare_serving(dlm, sparams, compressed=True,
                                        packed=True, bits_init=8.0,
                                        prune_sparsity=MOE_SPARSITY)
        draft = DraftModel(lm=dlm, params=dp, qparams=dq, meta=dmeta)
        tp, tq, _ = prepare_serving(slm, sparams)
        spec = Engine(slm, tp, tq, draft=draft, draft_k=SPEC_K,
                      max_slots=SLOTS, max_seq=max(PROMPT_LENS) + GEN)
        for pr in prompts:
            spec.submit(pr, GEN)
        spec.warmup()
        captured = _CAPTURES[0]
        out = spec.run()
        st = dict(spec.stats, **spec.throughput())
        per_k = {k: round(1e3 * spec.spec_round_s[k] / n, 3)
                 for k, n in sorted(spec.spec_rounds.items())}
        for pr in prompts[:SLOTS]:
            spec.submit(pr, SPEC_TRACE_GEN)
        short = spec.run()
        for pr in prompts[:SLOTS]:
            spec.submit(pr, SPEC_TRACE_GEN)
        held = True
        while spec.pending:
            spec.eager_step()
            held = held and _never_drafted(torch, spec)
        eager = spec._drain(spec.eager_step)
        same = _same(short, eager)
        ok = (same and held and _CAPTURES[0] == captured
              and sorted(spec.graphs) == spec._spec_ks()
              and len(out) == len(prompts))
        if not ok:
            failures.append("speculative: graph rounds differ from eager "
                            "rounds, the rollback left rows, or a capture "
                            "ran in a drain")
        print(f"[12c moe speculative] dense target, s{100 * MOE_SPARSITY:.0f}"
              f"/b8 MoE draft (experts {cfg.moe.n_experts} -> "
              f"{dlm.shapes[0].n_experts}), k {SPEC_K}, "
              f"{spec_layers} of 64 layers (reckoned peak "
              f"{spec_reckoned / 1e9:.1f} GB against {MOE_PEAK / 1e9:.0f} "
              f"GB{'' if spec_layers == MOE_LAYERS else ': depth cut'}): "
              f"decode {st['decode_tok_per_s']:.1f} tok/s "
              f"({st['decode_tokens']} committed tokens, {st['spec_steps']} "
              f"rounds), acceptance {st['acceptance_rate']:.3f}, ms per "
              f"round by k {per_k}; {SLOTS} requests x {SPEC_TRACE_GEN} "
              f"tokens in graph rounds {'==' if same else '!='} eager "
              f"rounds, rollback invariant after every eager round "
              f"{'held' if held else 'BROKEN'}; vs the plain engine "
              f"{_agreement(out, toks['dense']) if spec_layers == MOE_LAYERS else 'n/a (other depth)'}; "
              f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
              f"{'ok' if ok else 'FAIL'}")
        info["spec"] = {"acceptance": st["acceptance_rate"], "ms_per_k": per_k,
                        "layers": spec_layers}
        del spec, draft, dp, dq, tp, tq, dlm
        sparams = slm = params = lm = None
        torch.cuda.empty_cache()
    finally:
        gc.gemm = real
        fq.fake_quant_fwd = real_fwd
    counts = ops.launch_counts()
    peak_serve = torch.cuda.max_memory_allocated()

    # ---- 12d: one loss-and-gradient pass at 1 layer, widths full
    torch.cuda.reset_peak_memory_stats()
    tcfg = _moe_cfg(MOE_TRAIN_LAYERS)
    tlm = LM(tcfg)
    tparams = tlm.init(torch.Generator(device="cuda").manual_seed(0))
    tq = tlm.init_qparams(tparams, bits_init=16.0)
    batch = lm_batch(0, 0, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, tcfg.vocab,
                     device="cuda")
    L, E, D, F = (MOE_TRAIN_LAYERS, tcfg.moe.n_experts, tcfg.d_model,
                  tcfg.d_ff)
    stacks = {(L, E, D, F), (L, E, F, D)}       # we_gate / we_up, we_down
    checked, by_shape, check_s = [], Counter(), [0.0]
    real_bwd = fq.fake_quant_bwd

    def fwd(x, d, q_m, t):
        by_shape[("fwd", tuple(x.shape))] += 1
        return real_fwd(x, d, q_m, t)

    def bwd(x, d, q_m, t, g):
        by_shape[("bwd", tuple(x.shape))] += 1
        got = real_bwd(x, d, q_m, t, g)
        if tuple(x.shape) in stacks:
            torch.cuda.synchronize()
            t_check = time.perf_counter()
            checked.append(_fq_bwd_against_plain(torch, x, (d, q_m, t), g,
                                                 got))
            torch.cuda.synchronize()
            check_s[0] += time.perf_counter() - t_check
        return got

    before = ops.launch_counts()
    fq.fake_quant_fwd, fq.fake_quant_bwd = fwd, bwd
    try:
        t0 = time.perf_counter()
        loss, gx, gq = loss_and_grads(tlm, tparams, tq, batch)
        torch.cuda.synchronize()
        # the pass's own time: the checks against the plain version (run
        # inside its backward, where the cotangents live) excluded
        wall = time.perf_counter() - t0 - check_s[0]
    finally:
        fq.fake_quant_fwd, fq.fake_quant_bwd = real_fwd, real_bwd
    delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
    want = predicted_moe_grad_launches(tlm)
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in gx.values()) and all(
        bool(torch.isfinite(v).all()) for q_ in gq.values()
        for v in (q_.d, q_.q_m, q_.t))
    launches_ok = all(delta[k] == v for k, v in want.items())
    sums_ok = len(checked) == 3 and all(c["ok"] for c in checked)
    if not (finite and launches_ok and sums_ok):
        failures.append(f"moe training pass: finite {finite}, launches "
                        f"{ {k: delta[k] for k in want} } (want {want}), "
                        f"expert sites held {[c['ok'] for c in checked]}")
    print(f"[12d moe train] loss_and_grads at {MOE_TRAIN_LAYERS} of 64 layers "
          f"(widths full), batch {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}, 16-bit "
          f"init: loss {float(loss):.4f}, gradients finite {finite}, wall "
          f"{wall:.2f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.1f}"
          f" GB; expert sites' backward vs the plain version (dx bitwise, "
          f"sums/scale): "
          + ", ".join(f"{c['dx_bitwise']}/{max(c['sum_err_over_scale']):.1e}"
                      for c in checked)
          + f"; launches {{{', '.join(f'{k}: {delta[k]}' for k in want)}}} "
          f"(predicted {want}); fake-quant launches by shape "
          f"{dict(by_shape)} {'ok' if finite and launches_ok and sums_ok else 'FAIL'}")
    fq_shapes.update(by_shape)
    info["fq_shapes"] = fq_shapes
    info["train"] = {"wall_s": wall, "by_shape": {
        f"{d} {'x'.join(map(str, s))}": n for (d, s), n in by_shape.items()},
                     "peak_bytes": torch.cuda.max_memory_allocated()}
    del tparams, tq, gx, gq, loss, tlm
    torch.cuda.empty_cache()
    info["peak_serve_bytes"] = peak_serve
    print(f"[12 moe] peak device memory: serving {peak_serve / 1e9:.1f} GB "
          f"(reckoned resident {resident / 1e9:.1f} GB), training "
          f"{info['train']['peak_bytes'] / 1e9:.1f} GB; the phase took "
          f"{time.perf_counter() - t_start:.1f} s")
    return counts, dict(tally), failures, info


def predicted_moe_grad_launches(lm) -> dict:
    """Kernel launches of one MoE `loss_and_grads` pass: each routed
    projection (P, stacked over the layers) runs the fake_quant_rhs GEMM
    forward, again in the remat recompute, and for dx, and its dwq with
    no epilogue, all on the tensor-core variant; every other weight site
    (router, expert stacks, head) is fake-quantized once forward and once
    backward, a routed one backward only."""
    from repro_torch.core.subnet import _routed
    names = lm.quant_weight_names()
    routed = [n for n in names if n.startswith("blocks.") and _routed(n)]
    P = lm.n_blocks * len(routed)
    other = len(names) - len(routed)
    passes = 2 + int(lm.cfg.remat)
    return {"gemm_core.fake_quant_rhs": passes * P, "gemm_core.none": P,
            "gemm_core.tc": (passes + 1) * P,
            "fake_quant.bwd": P + other, "fake_quant.fwd": other}


# ----------------------------------------------------------------- phase 13
REC_ARCH = "rwkv6-3b"
REC_LAYERS = 8             # 13a-c's depth cut: 8 of 32 layers, widths full
HYB_ARCH = "jamba-1.5-large-398b"
# phase 5's traffic at lengths the recurrent prefill takes: a prompt past
# one scan chunk (64) must be a multiple of it (phase 5's 96 and 200 are not)
REC_PROMPT_LENS = [64, 128, 256, 512, 192, 320, 32, 384]
REC_PROMPT = 64            # 13a/13d's prefill-vs-decode prompt
REC_TRACE_STEPS = 16       # the traced decode window
REC_SPARSITY = 0.3         # 13b: 40 -> 28 heads, cm_hidden 8960 -> 6272;
                           # 13d: mamba Di 16384 -> 11469
REC_PEAK = 70e9            # 13c's device-memory budget, bytes
REC_EAGER_GEN = 16         # tokens of the eager drain held to the graph one
HYB_LAYERS = 8             # 13d's depth cut: one period of 72 layers
HYB_EXPERTS = 4            # 13d's expert cut: 4 of 16, top-2 kept
REC_MODES = {"dense": {}, "compressed": dict(compressed=True),
             "packed_b4": dict(packed=True, bits_init=4.0)}
# phase 3's rows at the recurrent shapes: (model, M, K, N, epilogues, x
# dtype, x a strided view). rwkv6 at decode (M = 4): the time-mix square
# projections and cm_r, cm_k, cm_v, the decay LoRA (decay_w2 takes the
# f32 tanh of decay_w1's product) and the head (served dense it is
# prequantized and multiplied by torch.matmul: a GEMM kernel runs it only
# from codes); cm_k at a 512-token prefill; jamba's in_proj_x / z,
# x_proj, dt_proj (x the split's strided view, rows 544 apart) and
# out_proj at decode and prefill
_EP3 = ("fake_quant_rhs", "dequant", "unpack_dequant_b4")
_EP2 = ("fake_quant_rhs", "dequant")
REC_GEMMS = ([("rwkv6", 4, K, N, _EP3, "bf16", False)
              for K, N in ((2560, 2560), (2560, 8960), (8960, 2560),
                           (2560, 64))]
             + [("rwkv6", 4, 64, 2560, _EP3, "f32", False),
                ("rwkv6", 4, 2560, 65536, _EP3[1:], "bf16", False),
                ("rwkv6", 512, 2560, 8960, _EP3, "bf16", False)]
             + [("jamba", M, K, N, _EP2, "bf16", K == 512)
                for M in (4, 512)
                for K, N in ((8192, 16384), (16384, 544), (512, 16384),
                             (16384, 8192))])


def _rec_gemm_name(model, M, K, N, label) -> str:
    return f"{_report_name(label)}.{model}.M{M}.{K}x{N}"


def phase_rec_kernels(torch, timer) -> tuple[list, dict, list]:
    """Phase 3's GEMM rows at the recurrent mixers' shapes (REC_GEMMS),
    each weight stored as `prepare_serving` stores it."""
    from repro_torch.kernels import gemm_core as gc
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows, report, failures = [], {}, []
    for model, M, K, N, epis, xdt, strided in REC_GEMMS:
        if strided:
            x = torch.randn((M, 544), generator=gen, device="cuda",
                            dtype=torch.bfloat16)[:, :K]
        else:
            x = torch.randn((M, K), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            if xdt == "f32":
                x = torch.tanh(x.float())
        for label, w, epi, dequantized in _gemm_cases(torch, K, N, gen):
            if label not in epis:
                continue
            row = _gemm_row(torch, timer, gc, label, x, gc.aligned_rows(w),
                            epi, dequantized(),
                            tag=f" ({model}, x {xdt}"
                                f"{', strided' if strided else ''})")
            rows.append(row)
            if not row["ok"]:
                failures.append(row)
            report[_rec_gemm_name(model, M, K, N, label)] = row
        del x
        torch.cuda.empty_cache()
    return rows, report, failures


def rwkv_reckoning(cfg, heads: int | None = None,
                   cm_hidden: int | None = None) -> dict:
    """rwkv6's params and bytes from the config alone, at `heads` time-mix
    heads and `cm_hidden` channel-mix units (the config's by default): bf16
    weights and mixes, f32 decay offsets, bonus, ln_x and norms; the
    decode state a slot holds (WKV f32, two f32 token shifts a layer)."""
    D, V, L, R = cfg.d_model, cfg.vocab_padded, cfg.n_layers, \
        cfg.rwkv.decay_lora
    dh = cfg.rwkv.head_size
    H = heads or D // dh
    F = cm_hidden or cfg.d_ff
    Dh = H * dh
    bf16 = 7 * D + 4 * D * Dh + Dh * D + D * R + R * Dh + 2 * D * F + D * D
    f32 = 4 * Dh + 2 * D
    return {"layer": bf16 + f32, "params": L * (bf16 + f32) + 2 * V * D + D,
            "param_bytes": 2 * (L * bf16 + 2 * V * D) + 4 * (L * f32 + D),
            "embed": V * D, "heads": H, "cm_hidden": F,
            "state_bytes_per_slot": L * (4 * H * dh * dh + 2 * 4 * D)}


def _rec_cfg():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(REC_ARCH), n_layers=REC_LAYERS)


def _hyb_cfg(layers: int = HYB_LAYERS, experts: int = HYB_EXPERTS):
    from repro_torch.configs import get_arch
    cfg = get_arch(HYB_ARCH)
    return dataclasses.replace(cfg, n_layers=layers, moe=dataclasses.replace(
        cfg.moe, n_experts=experts))


def hybrid_reckoning(cfg) -> dict:
    """jamba's params and bytes from the config alone (bf16 weights, f32
    A_log, D and norms) over its layer plan; the engine's fake-quanted
    copy of the expert stacks and the head; mamba state a layer a slot."""
    from repro_torch.models.transformer import layer_plan
    D, V, F, E = cfg.d_model, cfg.vocab_padded, cfg.d_ff, cfg.moe.n_experts
    mc = cfg.mamba
    Di, N, K = mc.expand * D, mc.d_state, mc.d_conv
    dtr = mc.dt_rank or D // 16
    plan, nb = layer_plan(cfg)
    attn = 2 * D * cfg.q_dim + 2 * D * cfg.kv_dim
    mamba = 2 * D * Di + K * Di + Di * (dtr + 2 * N) + dtr * Di + Di \
        + Di * D
    mamba_f32 = Di * N + Di
    experts = 3 * E * D * F + D * E
    mlp = 3 * D * F
    bf16 = f32 = 0
    for sub in plan:
        bf16 += attn if sub.mixer == "attn" else mamba
        f32 += (0 if sub.mixer == "attn" else mamba_f32) + 2 * D
        bf16 += experts if sub.ffn == "moe" else mlp
    bf16, f32 = nb * bf16 + 2 * V * D, nb * f32 + D
    n_moe = nb * sum(s.ffn == "moe" for s in plan)
    n_mamba = nb * sum(s.mixer == "mamba" for s in plan)
    n_attn = nb * sum(s.mixer == "attn" for s in plan)
    return {"params": bf16 + f32, "param_bytes": 2 * bf16 + 4 * f32,
            "expert_bytes": 2 * n_moe * 3 * E * D * F,
            "fq_copy_bytes": 2 * (n_moe * experts + V * D),
            "mamba_layers": n_mamba, "attn_layers": n_attn,
            "mamba_state_per_layer_slot": 4 * Di * N + 2 * (K - 1) * Di}


def _prefill_and_steps(torch, lm, params, qparams, toks, dtype):
    """(prefill's last logits, its cache, the last of as many eager decode
    steps' logits, their cache), both from empty rows in `dtype`."""
    with torch.no_grad():
        pre = lm.init_cache(1, toks.shape[1], dtype=dtype, device="cuda")
        want, _ = lm.prefill(params, qparams, pre, toks,
                             last_logit_only=True)
        seq = lm.init_cache(1, toks.shape[1], dtype=dtype, device="cuda")
        for i in range(toks.shape[1]):
            got, _ = lm.decode_step(params, qparams, seq, toks[:, i:i + 1],
                                    i)
    return want[0, -1].float(), pre, got[0, -1].float(), seq


def _state_gap(pre: dict, seq: dict) -> float:
    """The recurrent state leaves' largest gap relative to their max."""
    return max(((seq[k].float() - pre[k].float()).abs().max()
                / pre[k].float().abs().max().clamp_min(1e-30)).item()
               for k in pre if not (k.endswith(".k") or k.endswith(".v")))


def _rec_prefill_vs_decode(torch, eng, prompt, f32=None
                           ) -> tuple[bool, str]:
    """The one-shot prefill of one prompt against as many eager decode
    steps from an empty row, in bf16: the last logits by `_logits_held`,
    or, where that fails, within the prefill's own spread when every
    embedding weight moves by one bf16 ulp (a random-weight rwkv6 is that
    sensitive: see PERF.md). `f32`, a second (shorter) prompt, is held the
    same way on an f32 copy of the served weights, where `_logits_held`
    must hold. The state leaves' largest relative gap is printed."""
    lm, p, q = eng.lm, eng._run_params, eng._run_qparams
    toks = torch.as_tensor(prompt[None], dtype=torch.int64, device="cuda")
    want, pre, got, seq = _prefill_and_steps(torch, lm, p, q, toks,
                                             torch.bfloat16)
    ok, line = _logits_held(torch, got[None], want[None])
    gap = _state_gap(pre, seq)
    del pre, seq
    e = p["embed"].cpu()
    up = torch.rand(e.shape, generator=torch.Generator().manual_seed(23)) \
        < 0.5
    moved = torch.nextafter(e, torch.where(up, torch.inf, -torch.inf).to(
        e.dtype)).to("cuda")
    with torch.no_grad():
        wit, _ = lm.prefill(dict(p, embed=moved), q,
                            lm.init_cache(1, toks.shape[1],
                                          dtype=torch.bfloat16,
                                          device="cuda"),
                            toks, last_logit_only=True)
    del moved, up
    diff = (got - want).abs().max().item()
    spread = (wit[0, -1].float() - want).abs().max().item()
    held = ok or diff <= spread
    line += (f"; states' largest relative gap {gap:.2e}; the prefill's own "
             f"spread under one ulp on every embedding weight {spread:.4f} "
             f"({spread / max(want.abs().max().item(), 1e-30):.2e}): "
             f"{'held' if held else 'NOT held'}")
    if f32 is not None:
        p32 = {k: v.float() if v.is_floating_point() else v
               for k, v in p.items()}
        t32 = torch.as_tensor(f32[None], dtype=torch.int64, device="cuda")
        want, pre, got, seq = _prefill_and_steps(torch, lm, p32, q, t32,
                                                 torch.float32)
        ok32, l32 = _logits_held(torch, got[None], want[None])
        line += (f"; f32 copy of the weights, a {t32.shape[1]}-token "
                 f"prompt: {l32}, states' largest relative gap "
                 f"{_state_gap(pre, seq):.2e}")
        held = held and ok32
        del p32, pre, seq
    return held, line


def _solo(eng, out: dict, prompts, which) -> bool:
    """Requests `which` (indices into `prompts`, each admitted into a slot
    that served another request first) drained again alone: their tokens
    equal those of the batch drain `out`."""
    got = {}
    for i in which:
        eng.submit(prompts[i], GEN)
        got[i] = next(iter(eng.run().values()))
    order = sorted(out)
    return all(np.array_equal(got[i], out[order[i]]) for i in which)


def _routed_gemm_bytes(lm, params: dict) -> int:
    """Bytes of the served weights the small-M GEMMs read each decode
    step: every routed block projection's weight, codes or packed words,
    and the head when it is served from codes (dense, the head is a
    library product)."""
    from repro_torch.core.subnet import _routed
    from repro_torch.models.layers import PACKED_PARAM_BITS
    total = 0
    for name in lm.quant_weight_names():
        if not _routed(name):
            continue
        for key in ([name] if name.startswith("blocks.") else []) + [
                name + ".codes"] + [f"{name}.packed{b}"
                                    for b in PACKED_PARAM_BITS]:
            if key in params:
                total += params[key].numel() * params[key].element_size()
    return total


def _rec_engines(torch, lm, params, prompts, label, modes, failures,
                 info, trace_modes=(), f32_check=False):
    """Serve `prompts` from `lm` in each weight mode of `modes` over the
    contiguous arena, and the dense mode also over the paged one (without
    prefix sharing), each through graph windows then eager steps
    (`_moe_serve`: tokens bitwise equal, the eager drain REC_EAGER_GEN
    tokens of SLOTS requests); paged tokens equal contiguous tokens; in
    the dense contiguous engine, requests 4 and 7 (admitted into slots
    that served others) equal their solo drains, and its prefill against
    sequential decode (`f32_check`: also a 32-token prompt on an f32
    copy); a traced window per mode of `trace_modes`. Returns per-mode
    contiguous stats."""
    from repro_torch.core.subnet import prepare_serving
    stats = {}
    for mode in modes:
        p, q, meta = prepare_serving(lm, params, **REC_MODES[mode])
        toks = None
        for arena in ("contiguous", "paged") if mode == "dense" \
                else ("contiguous",):
            tag = f"{label} {mode}/{arena}"
            kw = (dict(paged=True, page_size=PAGE, prefix_sharing=False)
                  if arena == "paged" else {})
            t0 = time.perf_counter()
            eng, out, st, fails = _moe_serve(torch, lm, p, q, prompts, tag,
                                             eager_gen=REC_EAGER_GEN, **kw)
            failures += fails
            extra = ""
            if mode == "dense" and arena == "contiguous":
                solo = _solo(eng, out, prompts, (4, 7))
                extra += (f"; re-admitted requests 4, 7 "
                          f"{'equal' if solo else 'DIFFER FROM'} their solo "
                          f"drains")
                if not solo:
                    failures.append(f"{tag}: a re-admitted slot's tokens "
                                    f"differ from its solo drain")
            if arena == "contiguous":
                toks = out
                st["routed_gemm_bytes"] = _routed_gemm_bytes(lm, p)
                stats[mode] = st
                if mode in trace_modes:
                    tr = _moe_window_trace(torch, eng, prompts[:SLOTS],
                                           REC_PROMPT, REC_TRACE_STEPS)
                    st["trace"] = tr
                    gb = st["routed_gemm_bytes"]
                    tr["small_m_bound_ms"] = 1e3 * gb / HBM_BYTES_PER_S
                    extra += (
                        f"; a traced {REC_TRACE_STEPS}-step window: step "
                        f"wall {tr['wall_ms']:.3f} ms, busy "
                        f"{tr['busy_ms']:.3f} ms, idle share "
                        f"{tr['idle_share']:.3f}, {tr['kernels_per_step']:.0f}"
                        f" kernels a step; small-M GEMMs "
                        f"{tr['small_m_ms']:.3f} ms a step against their "
                        f"weights' byte bound {tr['small_m_bound_ms']:.3f} "
                        f"ms ({gb / 1e9:.2f} GB at 3.35 TB/s); library "
                        f"products {tr['expert_ms']:.3f} ms; glue "
                        f"{tr['glue_kernels']:.0f} kernels "
                        f"{tr['glue_ms']:.3f} ms a step")
                if mode == "dense":
                    ok, line = _rec_prefill_vs_decode(
                        torch, eng, prompts[REC_PROMPT_LENS.index(
                            REC_PROMPT)],
                        f32=prompts[REC_PROMPT_LENS.index(32)]
                        if f32_check else None)
                    extra += (f"; {REC_PROMPT}-token prefill vs "
                              f"{REC_PROMPT} eager decode steps: {line}")
                    if not ok:
                        failures.append(f"{tag}: prefill vs decode: {line}")
            else:
                same = _same(out, toks)
                extra += (f"; tokens {'equal' if same else 'DIFFER FROM'} "
                          f"the contiguous arena's")
                if not same:
                    failures.append(f"{tag}: paged tokens differ from "
                                    f"contiguous tokens")
            print(f"[13 recurrent] {tag}: decode "
                  f"{st['decode_tok_per_s']:.1f} tok/s "
                  f"({st['decode_tokens']} tokens, {st['decode_steps']} "
                  f"steps in {st['decode_s']:.3f} s), prefill "
                  f"{st['prefill_tok_per_s']:.1f} tok/s "
                  f"({st['prefill_tokens']} tokens in "
                  f"{st['prefill_s']:.3f} s), param_bytes "
                  f"{st['param_bytes']}, kv_bytes {st['kv_bytes']}, graphs "
                  f"{sorted(eng.graphs)} in {st['capture_s']:.2f} s, graph "
                  f"tokens {'==' if st['graph_eq_eager'] else '!='} eager "
                  f"step tokens, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, wall "
                  f"{time.perf_counter() - t0:.1f} s{extra}")
            del eng
            torch.cuda.empty_cache()
        del p, q
        torch.cuda.empty_cache()
    info[label] = {m: {k: v for k, v in st.items()
                       if isinstance(v, (int, float, dict))}
                   for m, st in stats.items()}
    return stats


def _rec_train(torch, failures) -> dict:
    """13c: `train_loop` on rwkv6-3b at full width and REC_LAYERS
    layers, 5 steps through every stage under
    torch.use_deterministic_algorithms, then two runs of a joint step from
    one state (bitwise)."""
    from repro_torch.configs import CompressionConfig
    from repro_torch.core.quant import bit_width
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models.transformer import LM

    def check(ok, what):
        if not ok:
            failures.append(f"13c {what}")
        return "ok" if ok else "FAIL"

    cfg = _rec_cfg()
    rk = rwkv_reckoning(cfg)
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    n = rk["params"]
    # params and gradients in bf16 (f32 leaves 4 bytes), AdamW's two f32
    # moments, the update's f32 temporaries (a step and a new value per
    # leaf), and one layer's recompute with its WKV chunk (states and
    # k v^T terms of 64 tokens, f32) and the f32 logits
    act = (batch * seq * cfg.d_model * 2 * cfg.n_layers
           + 3 * 64 * batch * cfg.d_model * cfg.rwkv.head_size * 4
           + 3 * batch * seq * cfg.vocab_padded * 4)
    reckoned = 2 * rk["param_bytes"] + 16 * n + act
    cut = ""
    if reckoned > REC_PEAK:
        batch //= 2
        cut = f" (reckoned peak past {REC_PEAK / 1e9:.0f} GB: batch halved)"
    print(f"[13c rwkv6 train] reckoned peak {reckoned / 1e9:.1f} GB: params "
          f"{rk['param_bytes'] / 1e9:.2f} GB, gradients as much, AdamW "
          f"moments {8 * n / 1e9:.1f} GB, the update's f32 temporaries as "
          f"much, activations and one layer's recompute "
          f"{act / 1e9:.1f} GB; batch {batch} x {seq}{cut}")
    torch.use_deterministic_algorithms(True)
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    hist = []
    t0 = time.perf_counter()
    state, qadg, qasso, losses = T.train_loop(
        REC_ARCH, False, 5, batch, seq, seed=0,
        comp=CompressionConfig(**COMP5), verbose=False, device="cuda",
        history=hist, layers=REC_LAYERS)
    wall = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    lm = LM(cfg)
    tokens = batch * seq
    for i, h in enumerate(hist):
        print(f"[13c rwkv6 train] step {i} stage {h['stage']} loss "
              f"{h['loss']:.4f} bits [{h['bits_min']:.2f}, "
              f"{h['bits_max']:.2f}] sparsity {h['sparsity_hard']:.4f} wall "
              f"{h['wall_s']:.3f} s {tokens / h['wall_s']:.1f} tok/s")
    stages = [h["stage"] for h in hist]
    keep = state["qstate"].keep_mask
    n_pruned = sum(int(torch.sum(v < 0.5)) for v in keep.values())
    b_l, b_u = qasso.cfg.bit_lower, qasso.cfg.bit_upper_final
    bits = [float(bit_width(q.d, q.q_m, q.t))
            for q in state["qparams"].values()]
    elem_keep = qasso._keep_elem_tree(state["params"], keep)
    nonzero = sum(int(torch.count_nonzero(
        p * (1.0 - elem_keep[k]).to(p.dtype)))
        for k, p in state["params"].items())
    print(f"[13c rwkv6 train] {REC_ARCH} full width bf16 ({cfg.n_layers} "
          f"of 32 layers, {n / 1e9:.2f}e9 params), batch {batch}x{seq}, 5 steps in "
          f"{wall:.2f} s, stages {stages} "
          f"{check(stages == [0, 1, 2, 2, 3], 'stage order')}, losses "
          f"finite {check(all(math.isfinite(x) for x in losses), 'loss')}, "
          f"pruned units {n_pruned} of {qasso.total_units} (k_units "
          f"{qasso.k_units}) {check(n_pruned == qasso.k_units, 'sparsity')}"
          f", nonzero pruned elements {nonzero} "
          f"{check(nonzero == 0, 'pruned units zero')}, bits "
          f"[{min(bits):.3f}, {max(bits):.3f}] in [{b_l}, {b_u}] "
          f"{check(b_l - 1e-3 <= min(bits) and max(bits) <= b_u + 1e-3, 'bits')}"
          f", peak memory {peak / 1e9:.1f} GB (reckoned "
          f"{reckoned / 1e9:.1f}) {check(peak <= REC_PEAK, 'peak memory')}")
    want = predicted_train_launches(lm, qasso, stages,
                                    f32_inputs=("rwkv.decay_w2",))
    got = {k: counts[k] for k in want}
    others = {k: v for k, v in counts.items() if v and k not in want}
    print(f"[13c rwkv6 train] launches {got} predicted {want} "
          f"{check(got == want and not others, 'train launch counts')}"
          + (f" unexpected {others}" if others else "")
          + " (decay_w2 takes the f32 tanh of the LoRA's first product: "
            "its GEMMs on the SIMT variant, every other on tensor cores)")
    del state, elem_keep
    torch.cuda.empty_cache()
    runs = []
    for _ in range(2):
        lm2, p, q, _, qa, s = T.init_geta(REC_ARCH, False, seed=0,
                                          device="cuda", comp=T.JOINT_STEP0,
                                          layers=REC_LAYERS)
        b = T.batch_for(lm2.cfg, 0, 0, batch, seq, device="cuda")
        p, q, s, m = T.make_geta_train_step(lm2, qa)(p, q, s, b)
        runs.append((p, q, s.redundant, s.keep_mask, m["loss"]))
        del s, b
        torch.cuda.empty_cache()
    (p0, q0, r0, k0, l0), (p1, q1, r1, k1, l1) = runs
    same = (all(_bitwise(torch, p0[k], p1[k]) for k in p0)
            and all(_bitwise(torch, getattr(q0[k], f), getattr(q1[k], f))
                    for k in q0 for f in ("d", "q_m", "t"))
            and all(_bitwise(torch, r0[k], r1[k])
                    and _bitwise(torch, k0[k], k1[k]) for k in r0)
            and _bitwise(torch, l0, l1))
    print(f"[13c rwkv6 train] two runs of a joint step 0 from one state: "
          f"params, quantizers, masks and loss "
          f"{'bitwise equal' if same else 'DIFFER'} "
          f"{check(same, 'train step reproducible')}")
    del runs, p0, p1, q0, q1
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    return {"wall_s": wall, "steps": [h["wall_s"] for h in hist],
            "tok_per_s": [tokens / h["wall_s"] for h in hist],
            "peak_bytes": peak, "reckoned_peak_bytes": reckoned,
            "batch": batch, "launches": got}


def phase_recurrent(torch) -> tuple[dict, dict, list[str], dict]:
    """Phase 13 (see the module docstring). Returns the launch counts of
    13a-d (zeroed before, read after), the GEMM launches by (variant,
    epilogue, K, N), the failures and the stats printed."""
    from collections import Counter
    from repro_torch.configs import get_arch
    from repro_torch.core.subnet import prepare_serving, tree_bytes
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import synthetic_prompts
    from repro_torch.models.transformer import LM
    t_start = time.perf_counter()
    failures, info = [], {}
    cfg = _rec_cfg()
    rk = rwkv_reckoning(cfg)
    print(f"[13 recurrent] {REC_ARCH} at its published widths (d_model "
          f"{cfg.d_model}, {rk['heads']} heads of "
          f"{cfg.rwkv.head_size}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, decay "
          f"LoRA {cfg.rwkv.decay_lora}, bf16), depth cut to "
          f"{cfg.n_layers} of {get_arch(REC_ARCH).n_layers} layers; "
          f"reckoned: "
          f"{rk['layer'] / 1e6:.2f}M params a layer, embed and head 2 x "
          f"{rk['embed'] / 1e6:.1f}M, {rk['params'] / 1e9:.3f}e9 params "
          f"({rk['param_bytes'] / 1e9:.2f} GB), decode state "
          f"{rk['state_bytes_per_slot'] / 1e6:.2f} MB a slot at any length")
    prompts = synthetic_prompts(cfg, REC_PROMPT_LENS, seed=0)
    ops.reset_launch_counts()
    tally = Counter()
    real = _gemm_shape_tally(gc, tally)
    try:
        # ---- 13a: rwkv6-3b at REC_LAYERS, every weight mode, both arenas
        torch.cuda.reset_peak_memory_stats()
        lm = LM(cfg)
        params = lm.init(torch.Generator(device="cuda").manual_seed(0))
        measured = tree_bytes(params)
        if measured != rk["param_bytes"]:
            failures.append(f"rwkv6 param bytes {measured} != reckoned "
                            f"{rk['param_bytes']}")
        _rec_engines(torch, lm, params, prompts, "13a rwkv6",
                     ("dense", "compressed", "packed_b4"), failures, info,
                     trace_modes=("dense", "compressed"), f32_check=True)

        # ---- 13b: pruned at sparsity 0.3
        slim = LM(cfg)
        p, q, meta = prepare_serving(slim, params,
                                     prune_sparsity=REC_SPARSITY)
        shp = slim.shapes[0]
        want = rwkv_reckoning(cfg, shp.rwkv_heads, shp.cm_hidden)
        eng, out, st, fails = _moe_serve(torch, slim, p, q, prompts,
                                         "13b rwkv6 pruned",
                                         eager_gen=REC_EAGER_GEN)
        failures += fails
        kv_want = SLOTS * want["state_bytes_per_slot"]
        wkv = tuple(eng.caches["blocks.0.wkv"].shape)
        ok = (shp.rwkv_heads == 28 and shp.cm_hidden == 6272
              and wkv[2] == 28 and st["kv_bytes"] == kv_want
              and meta["param_bytes"] == want["param_bytes"])
        if not ok:
            failures.append(f"13b pruned: heads {shp.rwkv_heads}, cm_hidden "
                            f"{shp.cm_hidden}, wkv {wkv}, kv "
                            f"{st['kv_bytes']} (want {kv_want}), params "
                            f"{meta['param_bytes']} (want "
                            f"{want['param_bytes']})")
        print(f"[13b rwkv6 pruned] sparsity {REC_SPARSITY}: realized "
              f"{meta['sparsity']:.3f}, heads {rk['heads']} -> "
              f"{shp.rwkv_heads}, cm_hidden {cfg.d_ff} -> {shp.cm_hidden}; "
              f"wkv leaves {wkv}; kv_bytes {st['kv_bytes']} (reckoned "
              f"{kv_want}); param_bytes {meta['param_bytes']} (the sliced "
              f"widths predict {want['param_bytes']}; unpruned "
              f"{rk['param_bytes']}); decode "
              f"{st['decode_tok_per_s']:.1f} tok/s, prefill "
              f"{st['prefill_tok_per_s']:.1f} tok/s; graph tokens "
              f"{'==' if st['graph_eq_eager'] else '!='} eager step tokens "
              f"{'ok' if ok and not fails else 'FAIL'}")
        info["13b"] = {"kv_bytes": st["kv_bytes"],
                       "param_bytes": meta["param_bytes"],
                       "decode_tok_per_s": st["decode_tok_per_s"]}
        del eng, p, q, slim, params, lm
        torch.cuda.empty_cache()

        # ---- 13c: GETA training at full width, REC_LAYERS deep
        info["13c"] = _rec_train(torch, failures)
        torch.cuda.empty_cache()

        # ---- 13d: jamba at its published widths, one period, 4 experts
        hcfg = _hyb_cfg()
        hk = hybrid_reckoning(hcfg)
        resident = hk["param_bytes"] + hk["fq_copy_bytes"]
        full = get_arch(HYB_ARCH)
        print(f"[13d jamba] {HYB_ARCH} at its published widths (d_model "
              f"{hcfg.d_model}, {hcfg.n_heads} heads / {hcfg.n_kv_heads} KV, "
              f"d_head {hcfg.d_head}, mamba d_state {hcfg.mamba.d_state} "
              f"d_conv {hcfg.mamba.d_conv} expand {hcfg.mamba.expand} "
              f"dt_rank {hcfg.mamba.dt_rank}, d_ff {hcfg.d_ff}, vocab "
              f"{hcfg.vocab}, bf16); cuts: depth {full.n_layers} -> "
              f"{HYB_LAYERS} layers (one period: {hk['attn_layers']} "
              f"attention, {hk['mamba_layers']} mamba; 4 MLP, 4 MoE), "
              f"experts {full.moe.n_experts} -> {HYB_EXPERTS} (top-"
              f"{hcfg.moe.top_k} kept); reckoned {hk['params'] / 1e9:.2f}e9 "
              f"params ({hk['param_bytes'] / 1e9:.1f} GB), the engine's "
              f"fake-quanted experts and head "
              f"{hk['fq_copy_bytes'] / 1e9:.1f} GB, resident "
              f"{resident / 1e9:.1f} GB, mamba state "
              f"{hk['mamba_state_per_layer_slot'] / 1e6:.2f} MB a layer a "
              f"slot")
        hprompts = synthetic_prompts(hcfg, REC_PROMPT_LENS, seed=0)
        torch.cuda.reset_peak_memory_stats()
        hlm = LM(hcfg)
        hparams = hlm.init(torch.Generator(device="cuda").manual_seed(0))
        measured = tree_bytes(hparams)
        if measured != hk["param_bytes"]:
            failures.append(f"jamba param bytes {measured} != reckoned "
                            f"{hk['param_bytes']}")
        hst = _rec_engines(torch, hlm, hparams, hprompts, "13d jamba",
                           ("dense", "compressed"), failures, info,
                           trace_modes=("dense",))
        tr = hst["dense"].get("trace")
        if tr is not None:
            lib = hk["expert_bytes"] + 2 * hcfg.vocab_padded * hcfg.d_model
            print(f"[13d jamba] dense traced window: mamba and the rest of "
                  f"the glue {tr['glue_ms']:.3f} ms a step "
                  f"({tr['glue_kernels']:.0f} kernels) beside the small-M "
                  f"GEMMs' {tr['small_m_ms']:.3f} ms (bound "
                  f"{tr['small_m_bound_ms']:.3f} ms); library products "
                  f"(experts, router, head) {tr['expert_ms']:.3f} ms a step "
                  f"against their byte bound "
                  f"{1e3 * lib / HBM_BYTES_PER_S:.3f} ms ({lib / 1e9:.1f} GB "
                  f"at 3.35 TB/s)")
        # int8 pruned at 0.3 over the contiguous arena: the full params go
        # once the sliced ones exist
        slim = LM(hcfg)
        p, q, meta = prepare_serving(slim, hparams, compressed=True,
                                     prune_sparsity=REC_SPARSITY)
        del hparams
        torch.cuda.empty_cache()
        shp = slim.shapes[1]
        eng, out, st, fails = _moe_serve(torch, slim, p, q, hprompts,
                                         "13d jamba pruned",
                                         eager_gen=REC_EAGER_GEN)
        failures += fails
        ok = shp.mamba_inner == 11469 and not fails
        if shp.mamba_inner != 11469:
            failures.append(f"13d pruned: mamba Di {shp.mamba_inner}")
        print(f"[13d jamba pruned] int8 at sparsity {REC_SPARSITY}: realized "
              f"{meta['sparsity']:.3f}, mamba Di {hcfg.mamba.expand * hcfg.d_model}"
              f" -> {shp.mamba_inner}, experts {HYB_EXPERTS} -> "
              f"{shp.n_experts}, KV heads {hcfg.n_kv_heads} -> "
              f"{slim.shapes[0].n_kv_heads}; param_bytes "
              f"{meta['param_bytes']}, kv_bytes {st['kv_bytes']}; decode "
              f"{st['decode_tok_per_s']:.1f} tok/s; graph tokens "
              f"{'==' if st['graph_eq_eager'] else '!='} eager step tokens, "
              f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
              f"{'ok' if ok else 'FAIL'}")
        del eng, p, q, slim, hlm
        torch.cuda.empty_cache()
    finally:
        gc.gemm = real
    counts = ops.launch_counts()
    need = ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
            "gemm_core.unpack_dequant", "gemm_core.none", "gemm_core.small_m",
            "gemm_core.tc", "gemm_core.simt", "decode_attn",
            "paged_decode_attn.bf16", "fake_quant.fwd", "fake_quant.bwd")
    idle = [k for k in need if not counts.get(k)]
    if idle:
        failures.append(f"phase 13 never launched {idle}")
    print(f"[13 recurrent] launches {_nonzero(counts)}; every kernel of the "
          f"path launched {'ok' if not idle else 'FAIL: ' + str(idle)}; the "
          f"phase took {time.perf_counter() - t_start:.1f} s")
    return counts, dict(tally), failures, info


# ----------------------------------------------------------------- phase 14
AUDIO_ARCH = "musicgen-large"
VLM_ARCH = "internvl2-26b"
AUDIO_PROMPT, AUDIO_GEN = 64, 64   # 14a's serve_loop: frames in, frames out
AUDIO_LAYERS = 24                  # 14a's depth cut: 24 of 48 layers (PR 26)
AUDIO_PREFILL = 32                 # 14a's prefill-vs-decode prompt (frames)
AUDIO_SPARSITY = 0.3               # 14a's pruned subnet
# 14a's serve_loop modes: packed b4 is held to int8 at the same 4-bit init
AUDIO_MODES = {"dense": {}, "int8": dict(compressed=True),
               "packed_b4": dict(packed=True, bits_init=4.0),
               "int8_b4": dict(compressed=True, bits_init=4.0)}
TRAIN_PEAK = 72e9                  # 14b's reckoned-peak budget for whole depth
VLM_LAYERS = 8                     # 14c's depth cut: 8 of 48 layers
VLM_TEXT = 512                     # 14c: text tokens after the 1024 patches
VLM_DECODE = 32                    # 14c: decode steps after the prefill
VLM_SERVE_TEXT = 64                # 14c's serve_loop: prompt_len 1024 + 64
VLM_TRAIN_LAYERS = 2               # 14c's GETA step: 2 of 48 layers
WINDOW = 256                       # 14d: internlm2-1.8b's sliding window
WINDOW_LAYERS = 12                 # 14d's depth cut: 12 of 24 layers (PR 26)
WINDOW_LENS = [32, 64, 128, 256, 96, 200, 160, 240]
# every request decodes past row 255 of its ring: n + gen >= WINDOW + 2
WINDOW_GENS = [max(128, WINDOW + 2 - n) for n in WINDOW_LENS]
WINDOW_LONG = 300                  # 14d: a prompt longer than the window
# phase 3's rows at the new shapes: internvl2's MLP projections and head at
# decode (M = 4) and w_gate / w_up at its prefill height (2 x 1536 tokens)
FRONT_GEMMS = [(4, 6144, 16384, _EP2), (4, 16384, 6144, _EP2),
               (4, 6144, 92672, _EP2),
               (2 * (1024 + VLM_TEXT), 6144, 16384, ("fake_quant_rhs",))]
# and decode attention at musicgen's MHA (KVh 32, g 1, dh 64) and on a
# windowed ring of 256 rows at positions past its end
FRONT_DECODE = {"musicgen": (SLOTS, DECODE_S, 32, 1, 64, DECODE_POS[:SLOTS]),
                "ring": (SLOTS, WINDOW, 8, 2, 128, [300, 255, 1000, 256])}
# predictions written before the first card run of phase 14 (PERF.md §6)
PREDICTED = {"14a_step_ms": 45.0, "14a_frames_per_s": 90.0,
             "14b_step_s": 2.0, "14c_prefill_s": 0.2, "14c_step_ms": 10.0,
             "14d_tok_per_s": 600.0, "phase_s": 160.0}


def _front_gemm_name(M, K, N, label) -> str:
    return f"{_report_name(label)}.internvl2.M{M}.{K}x{N}"


def phase_frontend_kernels(torch, timer) -> tuple[list, dict, list]:
    """Phase 3's rows at phase 14's new shapes (FRONT_GEMMS, weights
    stored as `prepare_serving` stores them; FRONT_DECODE)."""
    import itertools
    from repro_torch.kernels import gemm_core as gc
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows, report, failures = [], {}, []
    for M, K, N, epis in FRONT_GEMMS:
        x = torch.randn((M, K), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        for label, w, epi, dequantized in itertools.islice(
                _gemm_cases(torch, K, N, gen), 2):
            if label not in epis:
                continue
            row = _gemm_row(torch, timer, gc, label, x, gc.aligned_rows(w),
                            epi, dequantized(), tag=" (internvl2)")
            rows.append(row)
            if not row["ok"]:
                failures.append(row)
            report[_front_gemm_name(M, K, N, label)] = row
        del x
        torch.cuda.empty_cache()
    for name, (B, S, KVh, g, dh, pos) in FRONT_DECODE.items():
        pos = torch.tensor(pos, dtype=torch.int64, device="cuda")
        row = _decode_check(torch, timer, gen, B, S, KVh, g, dh, pos)
        rows.append(row)
        if not row["ok"]:
            failures.append(row)
        report[f"decode_attn.{name}"] = row
    return rows, report, failures


def lm_reckoning(cfg, kv_heads: int | None = None,
                 d_ff: int | None = None) -> dict:
    """A dense-family LM's params and bytes from the config alone, at
    `kv_heads` KV-head groups and `d_ff` MLP units (the config's by
    default): bf16 weights, f32 norms, the embedding (C, Vp, D) and head
    (D, C * Vp) with C codebooks (C = 1 without); served as int8 codes
    (`compress_lm` at 8 bits: a byte an element and one f32 scale a layer
    for every projection, one for the head; the embedding stays bf16);
    bf16 K/V bytes a token a slot."""
    D, dh, L = cfg.d_model, cfg.d_head, cfg.n_layers
    V = max(cfg.num_codebooks, 1) * cfg.vocab_padded
    KVh = kv_heads or cfg.n_kv_heads
    F = d_ff or cfg.d_ff
    Q, KV = KVh * cfg.gqa_group * dh, KVh * dh
    shapes = [(D, Q), (D, KV), (D, KV), (Q, D), (D, F), (D, F), (F, D)]
    layer = sum(k * n for k, n in shapes)
    norms = (2 * L + 1) * D
    return {"layer": layer, "params": L * layer + 2 * V * D + norms,
            "param_bytes": 2 * (L * layer + 2 * V * D) + 4 * norms,
            "int8_bytes": (L * (layer + 4 * len(shapes)) + V * D + 4
                           + 2 * V * D + 4 * norms),
            "kv_bytes_per_token": 2 * 2 * L * KV, "heads": KVh * cfg.gqa_group,
            "kv_heads": KVh, "d_ff": F}


class _CpuDrawnInit:
    """While active, `LM.init` draws from the CPU generator at the given
    generator's seed and moves the params to its device: the CPU and CUDA
    generators give different numbers from one seed, and the card-vs-CPU
    checks must serve one model."""

    def __enter__(self):
        import torch
        from repro_torch.models.transformer import LM
        self.real = real = LM.init

        def init(lm, gen):
            drawn = real(lm, torch.Generator().manual_seed(
                gen.initial_seed()))
            return {k: v.to(gen.device) for k, v in drawn.items()}

        LM.init = init
        return self

    def __exit__(self, *exc):
        from repro_torch.models.transformer import LM
        LM.init = self.real


def _traced_kernel_counts(torch, fn, matches) -> dict[str, int]:
    """Per name fragment in `matches`, the device kernels one call of `fn`
    runs, from one torch.profiler trace opened by TRACE_WARMUP int16 fill
    kernels, which are left out (as the card tests trace: a trace now and
    then loses the session's first kernels). A trace in which none of
    those fills shows is taken again, up to eight times."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    fill, marker = "FillFunctor<short>", torch.zeros(1, dtype=torch.int16,
                                                     device="cuda")
    names = []
    for _ in range(8):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(TRACE_WARMUP):
                marker.fill_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        keys = [e.key for e in prof.events() if e.device_type == cuda]
        if any(fill in k for k in keys):
            names = [k for k in keys if fill not in k]
            break
    return {m: sum(m in n for n in names) for m in matches}


def _audio_serving(torch, failures, info) -> None:
    """14a: musicgen-large at AUDIO_LAYERS through `serve_loop` (see the
    module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.subnet import (construct_subnet, prepare_serving,
                                         resolve_keep_masks, tree_bytes)
    from repro_torch.data.synthetic import batch_for
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_serve_step, serve_loop
    from repro_torch.models.transformer import LM
    full = get_arch(AUDIO_ARCH)
    cfg = dataclasses.replace(full, n_layers=AUDIO_LAYERS)
    rk = lm_reckoning(cfg)
    C, Vp = cfg.num_codebooks, cfg.vocab_padded
    weights = rk["param_bytes"] - 4 * (2 * cfg.n_layers + 1) * cfg.d_model \
        - 2 * C * Vp * cfg.d_model
    print(f"[14a musicgen] {AUDIO_ARCH} ({cfg.n_layers} of {full.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} MHA heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, {C} codebooks of vocab "
          f"{cfg.vocab}, bf16); reckoned {rk['params'] / 1e9:.3f}e9 params "
          f"({rk['param_bytes'] / 1e9:.2f} GB; int8 served "
          f"{rk['int8_bytes'] / 1e9:.2f} GB), KV "
          f"{rk['kv_bytes_per_token'] / 1e3:.0f} KB a frame a slot; the "
          f"block projections and head {weights / 1e9:.2f} GB: a decode step's "
          f"byte bound {1e3 * weights / HBM_BYTES_PER_S:.2f} ms; predicted "
          f"~{PREDICTED['14a_step_ms']:.0f} ms an eager step (host-bound), "
          f"~{PREDICTED['14a_frames_per_s']:.0f} frames/s at batch {SLOTS}")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    measured = tree_bytes(params)
    if measured != rk["param_bytes"]:
        failures.append(f"14a param bytes {measured} != reckoned "
                        f"{rk['param_bytes']}")
    # one-shot prefill against sequential decode, per codebook (int8)
    p, q, _ = prepare_serving(lm, params, compressed=True)
    toks = batch_for(cfg, 0, 0, 1, AUDIO_PREFILL, device="cuda")["tokens"]
    want, _, got, _ = _prefill_and_steps(torch, lm, p, q, toks,
                                         torch.bfloat16)
    ok, line = _logits_held(torch, got, want)
    if not ok:
        failures.append(f"14a prefill vs decode: {line}")
    print(f"[14a musicgen] int8: a {AUDIO_PREFILL}-frame one-shot prefill's "
          f"last ({C}, {Vp}) logits against {AUDIO_PREFILL} decode steps, "
          f"per codebook: {line} {'ok' if ok else 'FAIL'}")
    # one traced decode step: 7 small-M GEMMs a layer and the head's, a
    # split and a combine decode-attention kernel a layer
    step = make_serve_step(lm)
    cache = lm.init_cache(SLOTS, 8, dtype=torch.bfloat16, device="cuda")
    frame = toks[:1, :1].expand(SLOTS, 1, C).contiguous()
    with torch.no_grad():
        step(p, q, cache, frame, 0)
        seen = _traced_kernel_counts(
            torch, lambda: step(p, q, cache, frame, 1),
            ("gemm_small_m", "flash_decode_split", "flash_decode_combine"))
    want_n = {"gemm_small_m": 7 * cfg.n_layers + 1,
              "flash_decode_split": cfg.n_layers,
              "flash_decode_combine": cfg.n_layers}
    ok = seen == want_n
    if not ok:
        failures.append(f"14a traced decode step {seen} != {want_n}")
    print(f"[14a musicgen] int8 decode step traced: {seen}, predicted "
          f"{want_n} {'ok' if ok else 'FAIL'}")
    del p, q, cache
    torch.cuda.empty_cache()
    # the pruned subnet through construct_subnet (magnitude masks)
    t0 = time.perf_counter()
    qadg, masks = resolve_keep_masks(lm, params, AUDIO_SPARSITY)
    sub = construct_subnet(qadg, params, lm.init_qparams(params), masks)
    kv_kept = sub.params["blocks.0.attn.wk"].shape[-1] // cfg.d_head
    f_kept = sub.params["blocks.0.mlp.w_gate"].shape[-1]
    codes = sum(v.numel() * v.element_size()
                for v in sub.int_weights.values())
    m = sub.meta
    print(f"[14a musicgen] construct_subnet at sparsity {AUDIO_SPARSITY} in "
          f"{time.perf_counter() - t0:.2f} s: realized {m['sparsity']:.4f}, "
          f"heads {cfg.n_heads} -> {kv_kept}, d_ff {cfg.d_ff} -> {f_kept}, "
          f"{m['n_sites']} sites at mean {m['mean_bits']:.2f} bits, codes "
          f"{codes} B")
    pruned_rk = lm_reckoning(cfg, kv_heads=kv_kept, d_ff=f_kept)
    del sub, masks, qadg, params, lm
    torch.cuda.empty_cache()
    # serve_loop in every mode, then pruned (int8 on the sliced widths)
    prompts = batch_for(cfg, 0, 0, SLOTS, AUDIO_PROMPT)["tokens"]
    out, stats = {}, {}
    modes = dict(AUDIO_MODES, pruned_int8=dict(
        compressed=True, pruned=True, sparsity=AUDIO_SPARSITY))
    for mode, kw in modes.items():
        st = {}
        before = ops.launch_counts()["decode_attn"]
        out[mode] = serve_loop(AUDIO_ARCH, False, SLOTS, AUDIO_PROMPT,
                               AUDIO_GEN, prompts=prompts, verbose=False,
                               stats=st, device="cuda", layers=AUDIO_LAYERS,
                               **kw)
        st["decode_attn"] = ops.launch_counts()["decode_attn"] - before
        stats[mode] = st
        t = out[mode]
        fine = (t.shape == (SLOTS, AUDIO_GEN, C) and t.min() >= 0
                and t.max() < cfg.vocab_padded)
        if not fine:
            failures.append(f"14a {mode}: frames {t.shape} out of range")
        print(f"[14a musicgen] serve_loop {mode}: {SLOTS} x "
              f"{AUDIO_PROMPT} prompt frames, {AUDIO_GEN} generated "
              f"{t.shape}, {st['tok_per_s']:.1f} frames/s "
              f"({st['tok_per_s'] * C:.1f} tokens/s), param_bytes "
              f"{st['param_bytes']}, decode_attn launches "
              f"{st['decode_attn']} {'ok' if fine else 'FAIL'}")
        torch.cuda.empty_cache()
    same = np.array_equal(out["packed_b4"], out["int8_b4"])
    if not same:
        failures.append("14a packed b4 frames != int8 frames at 4-bit init")
    bytes_ok = (stats["int8"]["param_bytes"] == rk["int8_bytes"]
                and stats["pruned_int8"]["param_bytes"]
                == pruned_rk["int8_bytes"])
    if not bytes_ok:
        failures.append(f"14a int8 param bytes {stats['int8']['param_bytes']}"
                        f" / pruned {stats['pruned_int8']['param_bytes']} "
                        f"!= reckoned {rk['int8_bytes']} / "
                        f"{pruned_rk['int8_bytes']}")
    print(f"[14a musicgen] packed b4 frames "
          f"{'==' if same else '!='} int8 frames at the same 4-bit init; "
          f"int8 param_bytes {stats['int8']['param_bytes']} (reckoned "
          f"{rk['int8_bytes']}), pruned {stats['pruned_int8']['param_bytes']}"
          f" (reckoned at the sliced widths {pruned_rk['int8_bytes']}) "
          f"{'ok' if same and bytes_ok else 'FAIL'}")
    info["14a"] = {k: {f: st[f] for f in ("tok_per_s", "param_bytes",
                                          "decode_attn")}
                   for k, st in stats.items()}
    info["14a"]["pruned_widths"] = {"heads": kv_kept, "d_ff": f_kept}


def _audio_train(torch, failures, info) -> None:
    """14b: one GETA step per stage on musicgen-large (`train_loop`)."""
    from repro_torch.configs import CompressionConfig, get_arch
    from repro_torch.launch import train as T
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import LM
    cfg = get_arch(AUDIO_ARCH)
    rk = lm_reckoning(cfg)
    n = rk["params"]
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    # params and gradients in bf16 (norms f32), AdamW's two f32 moments,
    # the update's f32 temporaries, the remat's residual stream and one
    # layer's recompute (f32 scores) and the f32 logits of C codebooks
    act = (batch * seq * cfg.d_model * 2 * cfg.n_layers
           + 3 * batch * cfg.n_heads * seq * seq * 4
           + 3 * batch * seq * cfg.num_codebooks * cfg.vocab_padded * 4)
    reckoned = 2 * rk["param_bytes"] + 16 * n + act
    layers = cfg.n_layers
    while layers > 1 and reckoned > TRAIN_PEAK:
        layers -= 1
        cut = lm_reckoning(dataclasses.replace(cfg, n_layers=layers))
        reckoned = (2 * cut["param_bytes"] + 16 * cut["params"]
                    + act * layers // cfg.n_layers)
    print(f"[14b musicgen train] reckoned peak {reckoned / 1e9:.1f} GB "
          f"(params {rk['param_bytes'] / 1e9:.2f} GB, gradients as much, "
          f"AdamW moments {8 * n / 1e9:.1f} GB, the update's f32 "
          f"temporaries as much, activations {act / 1e9:.2f} GB): "
          + (f"whole depth, {layers} layers" if layers == cfg.n_layers else
             f"depth cut to {layers} of {cfg.n_layers} layers")
          + f"; batch {batch} x {seq} frames; predicted "
            f"~{PREDICTED['14b_step_s']:.1f} s a step")
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    hist = []
    t0 = time.perf_counter()
    state, qadg, qasso, losses = T.train_loop(
        AUDIO_ARCH, False, 5, batch, seq, seed=0,
        comp=CompressionConfig(**COMP5), verbose=False, device="cuda",
        history=hist, layers=(None if layers == cfg.n_layers else layers))
    wall = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    stages = [h["stage"] for h in hist]
    frames = batch * seq
    for i, h in enumerate(hist):
        print(f"[14b musicgen train] step {i} stage {h['stage']} loss "
              f"{h['loss']:.4f} sparsity {h['sparsity_hard']:.4f} wall "
              f"{h['wall_s']:.3f} s {frames / h['wall_s']:.1f} frames/s")
    keep = state["qstate"].keep_mask
    n_pruned = sum(int(torch.sum(v < 0.5)) for v in keep.values())
    lm = LM(dataclasses.replace(cfg, n_layers=layers))
    want = predicted_train_launches(lm, qasso, stages)
    got = {k: counts[k] for k in want}
    others = {k: v for k, v in counts.items() if v and k not in want}
    ok = (stages == [0, 1, 2, 2, 3]
          and all(math.isfinite(x) for x in losses)
          and n_pruned == qasso.k_units and got == want and not others
          and peak <= 80e9)
    if not ok:
        failures.append(f"14b train: stages {stages}, losses {losses}, "
                        f"pruned {n_pruned} of k_units {qasso.k_units}, "
                        f"launches {got} != {want} ({others})")
    print(f"[14b musicgen train] {layers} layers, 5 steps in {wall:.2f} s, "
          f"stages {stages}, pruned units {n_pruned} (k_units "
          f"{qasso.k_units}), peak {peak / 1e9:.1f} GB (reckoned "
          f"{reckoned / 1e9:.1f}); launches {got} predicted {want}"
          + (f" unexpected {others}" if others else "")
          + f" {'ok' if ok else 'FAIL'}")
    info["14b"] = {"layers": layers, "wall_s": wall,
                   "steps": [h["wall_s"] for h in hist],
                   "frames_per_s": [frames / h["wall_s"] for h in hist],
                   "peak_bytes": peak, "reckoned_peak_bytes": reckoned}
    del state, qadg, qasso


def _vision(torch, failures, info) -> None:
    """14c: internvl2-26b at its published widths, cut to VLM_LAYERS."""
    from repro_torch.configs import get_arch
    from repro_torch.core.subnet import prepare_serving, tree_bytes
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch import train as T
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.transformer import LM
    full = get_arch(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    rk = lm_reckoning(cfg)
    P = cfg.vision_patches
    S = P + VLM_TEXT
    print(f"[14c internvl2] {VLM_ARCH} at its published widths (d_model "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to "
          f"{cfg.vocab_padded}, {P} patches, bf16); cut: depth "
          f"{full.n_layers} -> {VLM_LAYERS} layers; reckoned "
          f"{rk['params'] / 1e9:.2f}e9 params ({rk['param_bytes'] / 1e9:.2f} "
          f"GB; whole {lm_reckoning(full)['params'] / 1e9:.1f}e9); prefill "
          f"2 x ({P} + {VLM_TEXT}) tokens: the GEMMs at M = {2 * S}, "
          f"~{2 * 2 * S * VLM_LAYERS * rk['layer'] / 1e12:.1f} TFLOP, "
          f"predicted ~{PREDICTED['14c_prefill_s']:.1f} s; a decode step "
          f"predicted ~{PREDICTED['14c_step_ms']:.0f} ms")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    measured = tree_bytes(params)
    if measured != rk["param_bytes"]:
        failures.append(f"14c param bytes {measured} != reckoned "
                        f"{rk['param_bytes']}")
    p, q, _ = prepare_serving(lm, params)
    del params
    b = batch_for(cfg, 0, 0, 2, S + VLM_DECODE, device="cuda")
    toks, vis = b["tokens"], b["vision_embeds"]
    with torch.no_grad():
        cache = lm.init_cache(2, S + VLM_DECODE, dtype=torch.bfloat16,
                              device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = lm.prefill(p, q, cache, toks[:, :VLM_TEXT],
                           vision_embeds=vis, last_logit_only=True)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(VLM_DECODE):
            lg, _ = lm.decode_step(p, q, cache,
                                   toks[:, VLM_TEXT + i:VLM_TEXT + i + 1],
                                   S + i)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / VLM_DECODE
        whole = lm.forward(p, q, toks, vis)[:, -1]
    ok, line = _logits_held(torch, lg[:, -1].float(), whole.float())
    if not ok:
        failures.append(f"14c vision prefill + decode vs forward: {line}")
    print(f"[14c internvl2] prefill(vision_embeds=) of 2 x ({P} patches + "
          f"{VLM_TEXT} text) in {t_pre:.3f} s "
          f"({2 * S / t_pre:.0f} tok/s), then {VLM_DECODE} decode steps "
          f"({1e3 * t_dec:.2f} ms a step): the last logits against "
          f"`forward` over the {S + VLM_DECODE} positions: {line} "
          f"{'ok' if ok else 'FAIL'}")
    del p, q, cache, whole, lg
    torch.cuda.empty_cache()
    stats = {}
    for mode, kw in (("dense", {}), ("int8", dict(compressed=True))):
        st = {}
        t = serve_loop(VLM_ARCH, False, SLOTS, P + VLM_SERVE_TEXT, 32,
                       verbose=False, stats=st, device="cuda",
                       layers=VLM_LAYERS, **kw)
        fine = (t.shape == (SLOTS, 32) and t.min() >= 0
                and t.max() < cfg.vocab_padded)
        if not fine:
            failures.append(f"14c serve_loop {mode}: {t.shape}")
        stats[mode] = {"tok_per_s": st["tok_per_s"],
                       "param_bytes": st["param_bytes"]}
        print(f"[14c internvl2] serve_loop {mode} (text only: prompt_len "
              f"{P + VLM_SERVE_TEXT} leaves {VLM_SERVE_TEXT} text tokens, "
              f"as the reference slices them), {SLOTS} x 32 tokens: "
              f"{st['tok_per_s']:.1f} tok/s, param_bytes "
              f"{st['param_bytes']} {'ok' if fine else 'FAIL'}")
        torch.cuda.empty_cache()
    # one GETA step at VLM_TRAIN_LAYERS layers on a 2 x (1024 + 512) batch
    torch.cuda.reset_peak_memory_stats()
    tlm, tp, tq, _, qasso, ts = T.init_geta(
        VLM_ARCH, False, seed=0, device="cuda", comp=T.JOINT_STEP0,
        layers=VLM_TRAIN_LAYERS)
    tb = batch_for(tlm.cfg, 0, 0, 2, S, device="cuda")
    t0 = time.perf_counter()
    loss, gx, gq = T.loss_and_grads(tlm, tp, tq, tb)
    finite = (math.isfinite(float(loss))
              and all(bool(torch.isfinite(g).all()) for g in gx.values())
              and all(math.isfinite(float(getattr(g, f)))
                      for g in gq.values() for f in ("d", "q_m", "t")))
    tp, tq, ts, met = qasso.update(tp, tq, gx, gq, ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not finite:
        failures.append("14c GETA step: a gradient is not finite")
    print(f"[14c internvl2 train] one GETA step (joint stage {met['stage']})"
          f" at {VLM_TRAIN_LAYERS} of {full.n_layers} layers on 2 x ({P} + "
          f"{VLM_TEXT}): loss {float(loss):.4f}, {len(gx)} parameter and "
          f"{len(gq)} quantizer gradients finite "
          f"{'ok' if finite else 'FAIL'}, {wall:.2f} s, peak "
          f"{peak / 1e9:.1f} GB")
    info["14c"] = {"prefill_s": t_pre, "decode_step_ms": 1e3 * t_dec,
                   "serve": stats, "train_wall_s": wall, "train_peak": peak}
    del tp, tq, ts, gx, gq, tb
    torch.cuda.empty_cache()


def _window(torch, failures, info) -> None:
    """14d: internlm2-1.8b at WINDOW_LAYERS with window = WINDOW, through
    the engine."""
    from repro_torch.configs import get_arch
    from repro_torch.core.subnet import prepare_serving
    from repro_torch.launch.engine import Engine, synthetic_prompts
    from repro_torch.launch.scheduler import ChunkedPrefillScheduler
    from repro_torch.launch.speculative import DraftModel
    from repro_torch.models.transformer import LM
    cfg = dataclasses.replace(get_arch(ARCH), window=WINDOW,
                              n_layers=WINDOW_LAYERS)
    rk = lm_reckoning(cfg)
    max_seq = max(n + g for n, g in zip(WINDOW_LENS, WINDOW_GENS))
    kv_want = SLOTS * WINDOW * rk["kv_bytes_per_token"]
    print(f"[14d window] {ARCH} at {WINDOW_LAYERS} of 24 layers with window "
          f"= {WINDOW} (the JAX "
          f"package's `window` field set on the published config: no config "
          f"of the repo sets one); {SLOTS} slots, prompts {WINDOW_LENS} "
          f"generating {WINDOW_GENS} (every request decodes past row "
          f"{WINDOW - 1}); reckoned ring arena {kv_want} B against "
          f"{SLOTS * max_seq * rk['kv_bytes_per_token']} B for max_seq "
          f"{max_seq} unwindowed; predicted "
          f"~{PREDICTED['14d_tok_per_s']:.0f} tok/s (phase 5's dense step)")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    p, q, _ = prepare_serving(lm, params)
    del params
    prompts = synthetic_prompts(cfg, WINDOW_LENS, seed=0)
    eng = Engine(lm, p, q, max_slots=SLOTS, max_seq=max_seq)
    for pr, g in zip(prompts, WINDOW_GENS):
        eng.submit(pr, g)
    eng.warmup()
    captured = _CAPTURES[0]
    out = eng.run()
    st = dict(eng.stats, **eng.throughput())
    for pr, g in zip(prompts, WINDOW_GENS):
        eng.submit(pr, g)
    eager = eng._drain(eng.step)
    ok = (_same(out, eager) and _CAPTURES[0] == captured
          and eng.kv_bytes() == kv_want
          and all(len(out[r]) == g for r, g in zip(sorted(out), WINDOW_GENS)))
    if not ok:
        failures.append(f"14d engine: graph == eager {_same(out, eager)}, "
                        f"kv_bytes {eng.kv_bytes()} (want {kv_want})")
    print(f"[14d window] engine: {len(out)} requests, decode "
          f"{st['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{st['prefill_tok_per_s']:.1f} tok/s, replays "
          f"{dict(eng.replays)}; graph-window tokens "
          f"{'==' if _same(out, eager) else '!='} eager step tokens; "
          f"kv_bytes {eng.kv_bytes()} (reckoned {kv_want}) "
          f"{'ok' if ok else 'FAIL'}")
    # the last decode logits of the longest request, past the wrap,
    # against the windowed forward over its whole sequence
    i = int(np.argmax([n + g for n, g in zip(WINDOW_LENS, WINDOW_GENS)]))
    rid = sorted(out)[i]
    seq = np.concatenate([prompts[i], out[rid][:-1]])
    n = len(prompts[i])
    with torch.no_grad():
        t = torch.as_tensor(seq[None], dtype=torch.int64, device="cuda")
        row = lm.init_cache(1, len(seq), dtype=torch.bfloat16, device="cuda")
        lm.prefill(eng._run_params, eng._run_qparams, row, t[:, :n],
                   last_logit_only=True)
        for j in range(n, len(seq)):
            got, _ = lm.decode_step(eng._run_params, eng._run_qparams, row,
                                    t[:, j:j + 1], j)
        want = lm.forward(eng._run_params, eng._run_qparams, t)[:, -1]
    held, line = _logits_held(torch, got[:, -1].float(), want.float())
    if not held:
        failures.append(f"14d decode past the wrap vs forward: {line}")
    print(f"[14d window] request {i} ({n} + {len(seq) - n} tokens, its ring "
          f"of {row['blocks.0.k'].shape[2]} rows wrapped "
          f"{(len(seq) - 1) // WINDOW} time(s)): the last decode step's "
          f"logits against the windowed `forward` over all "
          f"{len(seq)} tokens: {line} {'ok' if held else 'FAIL'}")
    del row, t, got, want
    # the refusals
    refused = {}
    attempts = {
        "paged": lambda: Engine(lm, p, q, max_slots=SLOTS, max_seq=max_seq,
                                paged=True),
        "speculative": lambda: Engine(lm, p, q, max_slots=SLOTS,
                                      max_seq=max_seq,
                                      draft=DraftModel(lm, p, q, {})),
        "chunked": lambda: Engine(lm, p, q, max_slots=SLOTS, max_seq=max_seq,
                                  scheduler=ChunkedPrefillScheduler(chunk=128)),
        f"{WINDOW_LONG}-token prompt": lambda: eng.submit(
            np.zeros(WINDOW_LONG, np.int32), 4)}
    for what, attempt in attempts.items():
        try:
            attempt()
            refused[what] = "accepted"
        except ValueError as e:
            refused[what] = str(e)[:60]
    ok = all(v != "accepted" for v in refused.values()) and not eng.queue
    if not ok:
        failures.append(f"14d refusals {refused}")
    print(f"[14d window] refused with ValueError: {refused} "
          f"{'ok' if ok else 'FAIL'}")
    info["14d"] = {"decode_tok_per_s": st["decode_tok_per_s"],
                   "prefill_tok_per_s": st["prefill_tok_per_s"],
                   "kv_bytes": eng.kv_bytes()}
    del eng, p, q
    torch.cuda.empty_cache()


def _frontends_card_vs_cpu(torch, failures) -> None:
    """The three features on their smoke configs (f32): the card's tokens
    against the CPU run of the plain versions, one model (CPU-drawn)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.subnet import prepare_serving
    from repro_torch.data.synthetic import vlm_batch
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.transformer import LM
    results = {}
    frames = np.random.default_rng(3).integers(0, 128, (2, 6, 4))
    with _CpuDrawnInit():
        results["musicgen serve_loop"] = [serve_loop(
            AUDIO_ARCH, True, 2, 6, 8, prompts=frames, verbose=False,
            device=dev) for dev in ("cuda", "cpu")]
    wcfg = dataclasses.replace(get_arch(ARCH, smoke=True), window=8)
    prompts = [np.random.default_rng(i).integers(0, 512, n).astype(np.int32)
               for i, n in enumerate((5, 8, 3, 7))]
    runs = []
    for dev in ("cuda", "cpu"):
        lm = LM(wcfg)
        base = lm.init(torch.Generator().manual_seed(0))
        p, q, _ = prepare_serving(lm, {k: v.to(dev) for k, v in base.items()})
        eng = Engine(lm, p, q, max_slots=2, max_seq=32)
        for pr, g in zip(prompts, (12, 9, 17, 10)):
            eng.submit(pr, g)
        eng.warmup()
        out = eng.run()
        runs.append(np.concatenate([out[r] for r in sorted(out)]))
    results["windowed engine"] = runs
    vcfg = get_arch(VLM_ARCH, smoke=True)
    b = vlm_batch(0, 0, 2, 6, vcfg.vocab, vcfg.vision_patches, vcfg.d_model,
                  dtype=torch.float32)
    runs = []
    for dev in ("cuda", "cpu"):
        lm = LM(vcfg)
        params = {k: v.to(dev) for k, v in lm.init(
            torch.Generator().manual_seed(0)).items()}
        cache = lm.init_cache(2, 24, dtype=torch.float32, device=dev)
        with torch.no_grad():
            lg, _ = lm.prefill(params, None, cache, b["tokens"].to(dev),
                               vision_embeds=b["vision_embeds"].to(dev),
                               last_logit_only=True)
            tok = torch.argmax(lg[:, -1], -1)[:, None]
            toks = [tok]
            for i in range(8):
                lg, _ = lm.decode_step(params, None, cache, tok,
                                       vcfg.vision_patches + 6 + i)
                tok = torch.argmax(lg[:, -1], -1)[:, None]
                toks.append(tok)
        runs.append(torch.cat(toks, 1).cpu().numpy())
    results["internvl2 vision prefill + decode"] = runs
    for what, (card, cpu) in results.items():
        same = np.array_equal(card, cpu)
        if not same:
            failures.append(f"14 card vs CPU: {what}")
        print(f"[14 frontends] smoke (f32) {what}: card tokens "
              f"{card.shape} {'==' if same else '!='} the CPU run's "
              f"{'ok' if same else 'FAIL'}")


def phase_frontends(torch) -> tuple[dict, dict, list[str], dict]:
    """Phase 14 (see the module docstring). Returns the launch counts of
    14a-d (zeroed before, read after), the GEMM launches by (variant,
    epilogue, K, N), the failures and the stats printed."""
    from collections import Counter
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import ops
    t_start = time.perf_counter()
    failures, info = [], {}
    ops.reset_launch_counts()
    tally = Counter()
    real = _gemm_shape_tally(gc, tally)
    try:
        for label, sub in (("14a", _audio_serving), ("14b", _audio_train),
                           ("14c", _vision), ("14d", _window)):
            t0 = time.perf_counter()
            before = ops.launch_counts()["decode_attn"]
            sub(torch, failures, info)
            info.setdefault(label, {})["decode_attn"] = \
                ops.launch_counts()["decode_attn"] - before
            print(f"[{label}] sub-phase seconds "
                  f"{time.perf_counter() - t0:.1f}")
            torch.cuda.empty_cache()
        counts = ops.launch_counts()
        _frontends_card_vs_cpu(torch, failures)
    finally:
        gc.gemm = real
    need = ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
            "gemm_core.unpack_dequant", "gemm_core.none", "gemm_core.small_m",
            "gemm_core.tc", "decode_attn", "fake_quant.fwd",
            "fake_quant.bwd")
    idle = [k for k in need if not counts.get(k)]
    if idle:
        failures.append(f"phase 14 never launched {idle}")
    print(f"[14 frontends] launches {_nonzero(counts)}; every kernel of the "
          f"path launched {'ok' if not idle else 'FAIL: ' + str(idle)}; the "
          f"phase took {time.perf_counter() - t_start:.1f} s (predicted "
          f"~{PREDICTED['phase_s']:.0f})")
    return counts, dict(tally), failures, info


# ------------------------------------------------------------- phase 15
# tensor-parallel serving and the sharded GETA step; the ranks are
# processes sharing the card (gloo with host-staged collectives), started
# once for the phase, after phase 2 built the kernel library
TP_SIZES = (2, 4)
TP_WORLD = 4
TP_MODES = {"dense": {}, "compressed": dict(compressed=True)}
# 15b's engines as (tp, mode, paged): both modes over both arenas at tp 4
# and 2, each decoding TP_GEN tokens a request: a collective staged
# through the host between processes that share the card costs
# milliseconds (PERF.md §7), so phases 5-6's 64 tokens a request took
# phase 15 to ~490 s (ROADMAP item 14b names the cut)
TP_ENGINES = [(tp, mode, paged) for tp in (4, 2) for mode in TP_MODES
              for paged in (False, True)]
TP_GEN = 8
TP_SEQ = max(PROMPT_LENS) + TP_GEN     # 15b's arena rows (max_seq)
# internlm2-1.8b's projections as (name, K, N, the dim the `model` axis
# splits): the columns of wq, wk / wv and w_gate / w_up, the rows of wo
# and w_down (their partial products summed in rank order); the head's
# vocab columns
TP_PROJ = [("wq", 2048, 2048, "N"), ("wk/wv", 2048, 1024, "N"),
           ("wo", 2048, 2048, "K"), ("w_gate/w_up", 2048, 8192, "N"),
           ("w_down", 8192, 2048, "K")]
TP_HEAD = (2048, 92672)
TP_KV_HEADS, TP_GROUP, TP_DHEAD = 8, 2, 128


def _tp_gemms() -> list:
    """(M, K, N, epilogues, roles) of every local GEMM a rank of 15b's
    engines launches: each projection's tile at tp 2 and 4, at decode
    (M = 4: small_m) and a 512-token prefill (tc), in both weight modes;
    the head's vocab tile at decode from codes only (the dense head is a
    prequantized torch.matmul)."""
    roles: dict = {}
    for tp in TP_SIZES:
        for name, K, N, dim in TP_PROJ:
            key = (K // tp, N) if dim == "K" else (K, N // tp)
            roles.setdefault(key, []).append(f"tp{tp} {name}")
    return ([(M, K, N, ("fake_quant_rhs", "dequant"), r)
             for (K, N), r in sorted(roles.items()) for M in (SLOTS, 512)]
            + [(SLOTS, TP_HEAD[0], TP_HEAD[1] // tp, ("dequant",),
                [f"tp{tp} head"]) for tp in TP_SIZES])


TP_GEMMS = _tp_gemms()
# decode attention's slots at 15b's arena, one past the end
TP_POS = [TP_SEQ - 1, 0, 300, 63]
# 15c: phase 10's depth cut, the training batch, 2 ranks, 3 steps: warm-up,
# projection, then a joint step that partitions and freezes the masks
TP_TRAIN_RANKS, TP_TRAIN_STEPS = 2, 3
TP_COMP = dict(target_sparsity=0.3, warmup_steps=1, projection_periods=1,
               projection_steps=1, pruning_periods=1, pruning_steps=1,
               cooldown_steps=0)
SMOKE_TP_LENS, SMOKE_TP_GEN = [12, 5, 9], 8
# predictions written before the first card run of phase 15 (PERF.md §6)
PREDICTED_TP = {"15a_gemm_2048_ms": 0.013, "15a_head_tile_ms": 0.03,
                "15a_decode_ms": 0.010, "15b_tp2_tok_per_s": 160.0,
                "15b_tp4_tok_per_s": 115.0, "15c_dp_step_s": 3.0,
                "15c_fsdp_step_s": 8.0, "15c_peak_gb": 14.0,
                "phase_s": 140.0}


def _tp_gemm_name(M, K, N, label) -> str:
    return f"{_report_name(label)}.tp.M{M}.{K}x{N}"


def phase_tp_kernels(torch, timer) -> tuple[list, dict, list]:
    """Phase 3's rows at every local shape of 15b's ranks (TP_GEMMS,
    weights as `prepare_serving` stores them; decode attention on 8 / tp
    KV heads of 15b's arena, contiguous and on bf16 pages), each held
    against its plain version and timed in this process as phase 3 times
    kernels; 15a holds the ranks' wrapper calls to the 1-rank kernels."""
    import itertools
    from repro_torch.kernels import gemm_core as gc
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows, report, failures = [], {}, []

    def keep(name, row):
        rows.append(row)
        if not row["ok"]:
            failures.append(row)
        report[name] = row

    for M, K, N, epis, _ in TP_GEMMS:
        x = torch.randn((M, K), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        for label, w, epi, dequantized in itertools.islice(
                _gemm_cases(torch, K, N, gen), 2):
            if label in epis:
                keep(_tp_gemm_name(M, K, N, label),
                     _gemm_row(torch, timer, gc, label, x,
                               gc.aligned_rows(w), epi, dequantized(),
                               tag=" (tp shard)"))
        del x
    pos = torch.tensor(TP_POS, dtype=torch.int64, device="cuda")
    for tp in TP_SIZES:
        shape = (SLOTS, TP_SEQ, TP_KV_HEADS // tp, TP_GROUP, TP_DHEAD)
        keep(f"decode_attn.tp{tp}",
             _decode_check(torch, timer, gen, *shape, pos))
        keep(f"paged_decode_attn.bf16.tp{tp}",
             _paged_check(torch, timer, gen, *shape, "bf16", pos))
    return rows, report, failures


def _tp_wrappers_rank(tp: int) -> dict | None:
    """15a on one rank of a tp mesh: `tp_gemm` at internlm2's full decode
    shapes (w_gate 2048->8192 in fake_quant_rhs and dequant, the head
    2048->92672 in dequant) and `tp_decode_attn` (KVh 8 -> 8/tp a rank),
    each bitwise against the 1-rank call on the same inputs, and w_down
    8192->2048 split on K (this rank's rows, partials summed in rank
    order, as the engine runs it) against the 1-rank call at phase 3's
    tolerance. Returns {case: (ok, max |diff|)}."""
    import torch
    from repro_torch.core.quant import init_quant_params, quantize_int
    from repro_torch.distributed.collectives import ordered_sum
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.launch import mesh as M
    mesh = M.make_tp_mesh(tp)
    if not mesh.member:
        return None
    gen = torch.Generator(device="cuda").manual_seed(151)
    out = {}

    def held(name, got, want, exact):
        diff = (got.float() - want.float()).abs().max().item()
        tol = 0.0 if exact else 1e-4 * want.float().abs().max().item()
        out[name] = (bool(diff <= tol and torch.isfinite(got).all()), diff)

    x = torch.randn((SLOTS, 2048), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    for K, N in ((2048, 8192), (2048, 92672)):
        w = torch.randn((K, N), generator=gen, device="cuda",
                        dtype=torch.bfloat16) * K ** -0.5
        qp = init_quant_params(w, bits=8.0)
        codes, d = quantize_int(w, qp, bits=8.0)
        cases = [("dequant", codes.to(torch.int8), gc.dequant(d))]
        if N == 8192:
            cases.append(("fake_quant_rhs", w,
                          gc.fake_quant_rhs(qp.d, qp.q_m, qp.t)))
        for label, w_, epi in cases:
            held(f"tp_gemm.{label}.{K}x{N}",
                 gc.tp_gemm(x, w_, epi, mesh=mesh), gc.gemm(x, w_, epi), True)
        del w, codes
    xd = torch.randn((SLOTS, 8192), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    wd = torch.randn((8192, 2048), generator=gen, device="cuda",
                     dtype=torch.bfloat16) * 8192 ** -0.5
    qp = init_quant_params(wd, bits=8.0)
    epi = gc.fake_quant_rhs(qp.d, qp.q_m, qp.t)
    lo, n = mesh.index("model") * (8192 // tp), 8192 // tp
    part = gc.gemm(xd[:, lo:lo + n], wd[lo:lo + n], epi,
                   out_dtype=torch.float32)
    held("k_split.fake_quant_rhs.8192x2048",
         ordered_sum(part, mesh, "model"),
         gc.gemm(xd, wd, epi, out_dtype=torch.float32), False)
    B, S, KVh, g, dh = SLOTS, DECODE_S, 8, 2, 128
    q = torch.randn((B, KVh, g, dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((B, S, KVh, dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((B, S, KVh, dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    pos = torch.tensor(DECODE_POS[:SLOTS], dtype=torch.int64, device="cuda")
    held("tp_decode_attn", da.tp_decode_attn(q, k, v, pos, mesh=mesh),
         da.decode_attn(q, k, v, pos), True)
    return out


def _tp_engine_rank(tp: int, mode: str, paged: bool,
                    prompts) -> dict | None:
    """15b on one rank: internlm2-1.8b at full width (bf16) served at tp
    on the first tp ranks, 4 slots, the 8 prompts of phases 5-6, TP_GEN
    tokens each; first the first decode step's logits
    (`_first_step_logits`), then the drain. The engine decodes eagerly
    (gloo), so `run()` needs no `warmup()`, which would only repeat the
    prefills. Launch counts are zeroed right before `run()` and read
    after; GEMM launches are also tallied by (variant, epilogue, K, N)."""
    from collections import Counter

    import torch
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import build_engine
    mesh = M.make_tp_mesh(tp)
    if not mesh.member:
        return None
    kw = dict(TP_MODES[mode])
    if paged:
        kw.update(paged=True, page_size=PAGE)
    t0 = time.perf_counter()
    eng, _ = build_engine(ARCH, False, max_slots=SLOTS, max_seq=TP_SEQ,
                          mesh=mesh, **kw)
    build_s = time.perf_counter() - t0
    info = {"param_bytes": eng.param_bytes(),
            "param_bytes_per_rank": eng.param_bytes(per_device=True),
            "kv_pool_bytes_per_rank": sum(
                eng._leaf_nbytes(c, True) for c in eng.caches.values()),
            "kv_pool_bytes": sum(eng._leaf_nbytes(c, False)
                                 for c in eng.caches.values()),
            "kv_bytes_per_rank": eng.kv_bytes(per_device=True),
            "kv_bytes": eng.kv_bytes(), "decode_mode": eng.decode_mode,
            "backend": mesh.backend, "staging": mesh.staging,
            "fallbacks": sorted({n for n, _, _ in eng.tp_fallbacks}),
            "build_s": build_s}
    info["logits"] = _first_step_logits(torch, eng, prompts,
                                        TP_GEN).cpu().numpy()
    tally = Counter()
    real = _gemm_shape_tally(gc, tally)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        toks = eng.run()
        torch.cuda.synchronize()
        info["drain_s"] = time.perf_counter() - t0
    finally:
        gc.gemm = real
    info.update(tokens={int(r): t.tolist() for r, t in toks.items()},
                launches=_nonzero(ops.launch_counts()),
                tally={"/".join(map(str, k)): v for k, v in tally.items()},
                peak_bytes=torch.cuda.max_memory_allocated(),
                **{k: eng.stats[k] for k in ("decode_steps", "decode_tokens",
                                             "decode_s", "prefill_tokens",
                                             "prefill_s")},
                **eng.throughput())
    del eng
    torch.cuda.empty_cache()
    return info


def _tp_smoke_rank(tp: int) -> dict | None:
    """15b's f32 check on one rank: the smoke config served at tp on the
    card from weights drawn on the CPU (seed 0, as the CPU run draws
    them); its tokens."""
    import torch
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import engine_serve
    from repro_torch.models.transformer import LM
    init = LM.init
    LM.init = lambda self, gen: {
        k: v.to(gen.device) for k, v in
        init(self, torch.Generator().manual_seed(0)).items()}
    try:
        st: dict = {}
        out = engine_serve(ARCH, True, SMOKE_TP_LENS, SMOKE_TP_GEN,
                           verbose=False, tp=tp, stats=st)
    finally:
        LM.init = init
    if not M.make_tp_mesh(tp).member:
        return None
    return {"tokens": {int(r): t.tolist() for r, t in out.items()},
            "decode_mode": st["decode_mode"]}


def _tp_train_rank(n: int, fsdp: bool, grad_slices: int) -> dict | None:
    """15c on one rank of an (n, 1) mesh (n = 1: the sequential
    reference): internlm2-1.8b at full width cut to RUN_LAYERS, the
    sharded GETA step over TP_TRAIN_STEPS steps (TP_COMP: warm-up,
    projection, a joint step that partitions) at batch 4 x 512. Returns
    the losses, each step's wall seconds, the peak memory, the launch
    counts, and digests of the gathered params, quantizers and masks
    (every rank's checked identical first)."""
    import hashlib

    import torch
    from repro_torch.configs import CompressionConfig, get_overrides
    from repro_torch.data.synthetic import batch_for
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.collectives import assert_replicated
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T
    mesh = M.make_subset_mesh(n)
    if not mesh.member:
        return None
    dev = torch.device("cuda", torch.cuda.current_device())
    lm, params, qparams, _, qasso, qstate = T.init_geta(
        ARCH, False, seed=0, comp=CompressionConfig(**TP_COMP), device=dev,
        layers=RUN_LAYERS)
    plan = S.make_plan(mesh, fsdp=fsdp, overrides=dict(get_overrides(ARCH)))
    p_sh = plan.shardings(lm.param_axes(),
                          {k: tuple(v.shape) for k, v in params.items()})
    step, (psh, _, ssh, bsh) = T.make_sharded_geta_train_step(
        lm, qasso, mesh, params, qparams, param_shardings=p_sh,
        grad_slices=grad_slices)
    params, qstate = S.place(params, psh), S.place(qstate, ssh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, walls = [], []
    for i in range(TP_TRAIN_STEPS):
        b = S.place(batch_for(lm.cfg, 0, i, TRAIN_BATCH, TRAIN_SEQ,
                              device=dev), bsh)
        t0 = time.perf_counter()
        params, qparams, qstate, m = step(params, qparams, qstate, b)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    counts = _nonzero(ops.launch_counts())
    peak = torch.cuda.max_memory_allocated()
    full = S.gather_tree(params, psh)
    masks = {**{"r." + k: v for k, v in qstate.redundant.items()},
             **{"k." + k: v for k, v in qstate.keep_mask.items()}}
    for k, v in masks.items():
        assert_replicated(v, mesh, k)
    digest = lambda tree: hashlib.sha256(b"".join(
        tree[k].detach().contiguous().view(torch.uint8).cpu().numpy()
        .tobytes() for k in sorted(tree))).hexdigest()
    out = {"losses": losses, "walls": walls, "peak_bytes": peak,
           "launches": counts, "params": digest(full),
           "masks": digest(masks),
           "qparams": {k: (float(q.d), float(q.q_m), float(q.t))
                       for k, q in qparams.items()},
           "stage": int(m["stage"]),
           "sparsity": float(m["sparsity_hard"]),
           "n_params": sum(v.numel() for v in full.values()),
           "sharded": sum(1 for s in psh.values() if any(s.spec))}
    del full, params, qstate
    torch.cuda.empty_cache()
    return out


def _tp_reckoning(n_params: int, ranks: int) -> str:
    """A rank's device memory for the sharded step, reckoned: bf16 params,
    AdamW's two f32 moments, f32 gradients; FSDP keeps a shard of the
    params and moments and gathers the params whole inside a step."""
    gb = lambda b: f"{b / 1e9:.2f} GB"
    return (f"{n_params} params: bf16 params {gb(2 * n_params)}, AdamW "
            f"moments {gb(8 * n_params)}, f32 gradients {gb(4 * n_params)}"
            f" -> ~{gb(14 * n_params)} a rank in DP; FSDP keeps "
            f"~{gb(10 * n_params / ranks)} between steps and holds "
            f"~{gb(6 * n_params + 10 * n_params / ranks)} inside one (the "
            f"params gathered, the gradients whole); + activations of a "
            f"1 x {TRAIN_SEQ} slice")


def phase_tp(torch, outs: dict, report: dict
             ) -> tuple[dict, dict, list[str], dict]:
    """Phase 15 (see the module docstring). `outs` are phase 5's tokens
    (the 1-rank engine's, graph windows), `report` phase 3's rows at the
    ranks' local shapes. Returns the summed launch counts of the ranks'
    main-path runs, 15b's launches summed over the ranks by (tp, variant,
    epilogue, K, N) for the GEMMs and (tp, kernel) for decode attention,
    the failures and the numbers for --out."""
    from collections import Counter
    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import build_engine, synthetic_prompts
    failures, info = [], {}
    counts, tally = Counter(), Counter()
    prompts = synthetic_prompts(get_arch(ARCH), PROMPT_LENS, seed=0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with M.RankPool(TP_WORLD, "cuda") as pool:
        print(f"[15 tp] {TP_WORLD} ranks on one card over {pool.backend}"
              f"{' (host-staged collectives)' if pool.staging else ''}, "
              f"started in {time.perf_counter() - t0:.1f} s")
        # 15a: the wrappers against the 1-rank kernels
        for tp in TP_SIZES:
            res = [r for r in pool.run(_tp_wrappers_rank, tp) if r]
            for case in res[0]:
                oks = [r[case][0] for r in res]
                diff = max(r[case][1] for r in res)
                print(f"[15a tp wrappers] tp={tp} {case}: max|diff| vs the "
                      f"1-rank call {diff:.3e} "
                      f"({'bitwise' if diff == 0 else 'tol 1e-4 x max|y|'})"
                      f" on {len(res)} ranks {'ok' if all(oks) else 'FAIL'}")
                if not all(oks):
                    failures.append(f"15a tp={tp} {case}: {diff}")
        # 15b: the engine at full width, against phase 5's 1-rank tokens
        base_logits = {}
        for mode in TP_MODES:
            eng, _ = build_engine(ARCH, False, max_slots=SLOTS,
                                  max_seq=TP_SEQ, device="cuda",
                                  **TP_MODES[mode])
            base_logits[mode] = _first_step_logits(torch, eng, prompts,
                                                   TP_GEN).cpu()
            del eng
            torch.cuda.empty_cache()
        for tp, mode, paged in TP_ENGINES:
            t1 = time.perf_counter()
            res = [r for r in pool.run(_tp_engine_rank, tp, mode,
                                       paged, prompts) if r]
            r0, label = res[0], (f"tp={tp} {mode} "
                                 f"{'paged' if paged else 'contiguous'}")
            same_ranks = all(r["tokens"] == r0["tokens"] for r in res)
            ok = same_ranks
            got = {k: np.asarray(v) for k, v in r0["tokens"].items()}
            held, line = _logits_held(
                torch, torch.from_numpy(r0["logits"]),
                base_logits[mode])
            ok = ok and held
            # phase 5's 1-rank tokens, cut to TP_GEN
            want = {k: v[:TP_GEN] for k, v in outs[mode].items()}
            kv_exact = (r0["kv_pool_bytes_per_rank"] * tp
                        == r0["kv_pool_bytes"])
            steps = max(r0["decode_steps"], 1)
            launched = Counter()
            for r in res:
                launched.update(r["launches"])
                for k, v in r["tally"].items():
                    var, epi, K, N = k.split("/")
                    tally[(tp, var, epi, int(K), int(N))] += v
            attn = "paged_decode_attn.bf16" if paged else "decode_attn"
            tally[(tp, attn)] += launched[attn]
            counts.update(launched)
            main_ok = (launched["gemm_core.small_m"] > 0
                       and launched["gemm_core.tc"] > 0
                       and launched[attn] > 0)
            ok = ok and kv_exact and main_ok and len(got) == len(
                PROMPT_LENS)
            info[label] = {k: v for k, v in r0.items()
                           if k not in ("tokens", "logits")}
            print(f"[15b tp engine] {label}: {r0['backend']}"
                  f"{' host-staged' if r0['staging'] else ''}, "
                  f"decode {r0['decode_mode']}; every rank's tokens "
                  f"{'equal' if same_ranks else 'DIFFER'}; "
                  f"vs the 1-rank engine (phase 5): "
                  f"{_agreement(got, want)}; first step {line}; decode "
                  f"{r0['decode_tok_per_s']:.1f} tok/s, "
                  f"step {1e3 * r0['decode_s'] / steps:.2f} ms "
                  f"({r0['decode_steps']} steps), prefill "
                  f"{r0['prefill_tok_per_s']:.1f} tok/s; per-rank "
                  f"param_bytes {r0['param_bytes_per_rank']} of "
                  f"{r0['param_bytes']}, kv pool "
                  f"{r0['kv_pool_bytes_per_rank']} of "
                  f"{r0['kv_pool_bytes']} "
                  f"({'exactly 1/tp' if kv_exact else 'NOT 1/tp'}), "
                  f"peak {r0['peak_bytes'] / 1e9:.2f} GB a rank; "
                  f"fallbacks {r0['fallbacks'] or 'none'}; launches "
                  f"(all ranks) {dict(launched)}; "
                  f"{time.perf_counter() - t1:.1f} s "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"15b {label}")
        # every local GEMM the engines launched has a phase-3 row
        checked = {(r["variant"], r["kernel"].split(".")[1], r["K"], r["N"])
                   for r in report.values() if "variant" in r}
        launched_shapes = {k[1:] for k in tally if len(k) == 5}
        missed = sorted(launched_shapes - checked)
        print(f"[15b tp engine] {len(launched_shapes)} local GEMM shapes "
              f"(variant, epilogue, K, N) launched, each held against its "
              f"plain version in phase 3"
              + (f" but for {missed} FAIL" if missed else " ok"))
        if missed:
            failures.append(f"15b GEMM shapes without a phase-3 row: "
                            f"{missed}")
        from repro_torch.launch.engine import engine_serve
        want = engine_serve(ARCH, True, SMOKE_TP_LENS, SMOKE_TP_GEN,
                            verbose=False, device="cpu")
        res = [r for r in pool.run(_tp_smoke_rank, 4) if r]
        same = all({int(k): list(v) for k, v in want.items()} == r["tokens"]
                   for r in res)
        print(f"[15b tp engine] smoke config (f32) at tp=4 on the card, "
              f"decode {res[0]['decode_mode']}: tokens "
              f"{'equal' if same else 'DIFFER FROM'} the CPU run's on every "
              f"rank ({len(want)} requests x {SMOKE_TP_GEN}) "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            failures.append("15b smoke tp=4 card vs CPU")
        # 15c: the sharded GETA step
        torch.cuda.empty_cache()
        ref = _tp_train_rank(1, False, TP_TRAIN_RANKS)
        print(f"[15c sharded step] {_tp_reckoning(ref['n_params'], TP_TRAIN_RANKS)}")
        print(f"[15c sharded step] 1 rank, grad_slices={TP_TRAIN_RANKS}: "
              f"losses {ref['losses']}, step walls "
              f"{[round(w, 2) for w in ref['walls']]} s, peak "
              f"{ref['peak_bytes'] / 1e9:.2f} GB, stage {ref['stage']}, "
              f"sparsity {ref['sparsity']:.3f}")
        for fsdp in (False, True):
            res = [r for r in pool.run(_tp_train_rank, TP_TRAIN_RANKS, fsdp,
                                       TP_TRAIN_RANKS) if r]
            same = all(r[k] == ref[k] for r in res for k in (
                "losses", "params", "masks", "qparams"))
            launched = Counter()
            for r in res:
                launched.update(r["launches"])
            counts.update(launched)
            ok = same and launched["fake_quant.fwd"] > 0 and launched[
                "fake_quant.bwd"] > 0 and launched["gemm_core.tc"] > 0
            print(f"[15c sharded step] {TP_TRAIN_RANKS} ranks "
                  f"{'FSDP' if fsdp else 'DP'} ({res[0]['sharded']} params "
                  f"sharded): loss, params, quantizers and masks "
                  f"{'bitwise equal to' if same else 'DIFFER FROM'} the "
                  f"1-rank step over {TP_TRAIN_STEPS} steps; step walls "
                  f"{[round(w, 2) for w in res[0]['walls']]} s, peak "
                  f"{[round(r['peak_bytes'] / 1e9, 2) for r in res]} GB a "
                  f"rank; launches (all ranks) {dict(launched)} "
                  f"{'ok' if ok else 'FAIL'}")
            info[f"15c {'fsdp' if fsdp else 'dp'}"] = {
                k: v for r in res[:1] for k, v in r.items()}
            if not ok:
                failures.append(f"15c {'fsdp' if fsdp else 'dp'}")
        info["15c reference"] = ref
    for name in ("gemm_core.small_m", "gemm_core.tc", "decode_attn",
                 "paged_decode_attn.bf16", "fake_quant.fwd",
                 "fake_quant.bwd"):
        if counts[name] <= 0:
            failures.append(f"{name} never launched on phase 15's path")
    print(f"[15 tp] launch counts of the ranks' main-path runs (host "
          f"calls, all eager): {_nonzero(dict(counts))}")
    print(f"[15 tp] predictions (PERF.md): {PREDICTED_TP}")
    return dict(counts), dict(tally), failures, info


def _tp_kernel_rows(tp_report: dict, tp_tally: dict, gemm, attn,
                    paged) -> list:
    """The kernel line's rows at a tp rank's local shapes (phase 3's
    rows), with phase 15b's launches at each row's (variant, epilogue, K,
    N), or its tp and arena for decode attention, summed over the engines
    and their ranks. `gemm`, `attn`, `paged`: (source, replaces) pairs."""
    out = []
    for M, K, N, epis, roles in TP_GEMMS:
        for label in epis:
            name = _tp_gemm_name(M, K, N, label)
            row = tp_report[name]
            key = (row["variant"], _report_name(label).split(".")[1], K, N)
            out.append({
                "name": name, "route": "cuda", "source": gemm[0],
                "replaces": gemm[1],
                "launches": sum(v for k, v in tp_tally.items()
                                if k[1:] == key),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"M={M} K={K} N={N} ({', '.join(roles)} of "
                         f"{ARCH})", "variant": row["variant"],
                **({"block_height_ms": row["heights"]} if "heights" in row
                   else {"kernels_per_launch": row.get("kernels_per_call")})})
    for tp in TP_SIZES:
        for base, (src, replaces) in (("decode_attn", attn),
                                      ("paged_decode_attn.bf16", paged)):
            row = tp_report[f"{base}.tp{tp}"]
            out.append({
                "name": f"{base}.tp{tp}", "route": "cuda", "source": src,
                "replaces": replaces, "launches": tp_tally.get((tp, base), 0),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"B={row['B']} S={row['S']} KVh={row['KVh']} "
                         f"g={row['g']} dh={row['dh']}"
                         + (f" P={row['P']}" if "P" in row else "")
                         + f" R={row['R']} q bf16, pos int64 (a tp-{tp} "
                         f"rank's {row['KVh']} of {TP_KV_HEADS} KV heads)",
                "kernels_per_launch": row["kernels_per_call"]})
    return out


# ----------------------------------------------------------------- phase 16
# 16a: the paper's runners at the full specs, each cut to steps=12 (11
# QASSO steps through every stage; the reference runs 120-240): (label,
# runner, positional args, keyword args, unit, per-step count)
RUNNER_STEPS = 12
RUNNER_STAGES = [0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3]
DRY_BATCH, DRY_SEQ = TRAIN_BATCH, TRAIN_SEQ     # 16b's GETA step, 4 x 512


def runners() -> list[tuple]:
    """Phase 16a's runs (see the module docstring)."""
    from repro_torch.launch import experiments as E
    from repro_torch.models import cnn
    img, tok = ("images", 64), ("tokens", 16 * 64)
    return [("resnet20 baseline", E.run_baseline_cnn, (cnn.RESNET20,), {},
             img),
            ("resnet20 geta", E.run_geta_cnn, (cnn.RESNET20,),
             dict(sparsity=0.35), img),
            ("vgg7 baseline", E.run_baseline_cnn, (cnn.VGG7,), {}, img),
            ("vgg7 geta w+a", E.run_geta_cnn, (cnn.VGG7,),
             dict(sparsity=0.5, act_quant=True), img),
            ("resnet56 geta sp40", E.run_geta_cnn, (cnn.RESNET56,),
             dict(sparsity=0.4), img),
            ("bert geta sp30", E.run_geta_bert, (0.3,),
             dict(encoder=E.BERT_FULL), tok),
            ("bert prune+ptq sp30", E.run_prune_then_ptq_bert, (0.3,),
             dict(encoder=E.BERT_FULL), tok)]


def predicted_runner_launches(facts: dict) -> dict:
    """Fake-quant launches of a GETA runner: every weight and activation
    site once forward and once backward a step, each quantized param once
    more in a joint step (`predicted_substrate_launches`), and the
    evaluation tail's one forward (accuracy or exact match)."""
    sites = facts["n_weight_sites"] + facts["n_act_sites"]
    steps = len(facts["stages"])
    joint = sum(s == 2 for s in facts["stages"]) * facts["n_quantized_params"]
    return {"fake_quant.fwd": sites * (steps + 1) + joint,
            "fake_quant.bwd": sites * steps}


def _runners(torch, failures, info) -> None:
    from repro_torch.kernels import ops

    def check(ok, what):
        if not ok:
            failures.append(f"16a {what}")
        return "ok" if ok else "FAIL"

    for label, fn, args, kw, (unit, per_step) in runners():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = fn(*args, steps=RUNNER_STEPS, device="cuda", **kw)
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        walls = r.get("step_walls") or []
        wall = statistics.median(walls)
        metric = (f"acc {r['acc']:.4f}" if "acc" in r
                  else f"em {r['em']:.4f}")
        losses = r.get("losses") or []
        line = (f"[16a runners] {label}: {metric}, rel_bops "
                f"{r['rel_bops']:.5f}, losses finite "
                f"{check(bool(losses) and all(map(math.isfinite, losses)), f'{label} finite losses')}"
                f", step wall median {wall:.4f} s, {per_step / wall:.1f} "
                f"{unit}/s, {secs:.1f} s")
        gemm = {k: v for k, v in counts.items()
                if k.startswith("gemm_core") and v}
        if "stages" in r:
            want = predicted_runner_launches(r)
            got = {k: counts[k] for k in want}
            geta = "ptq" not in label
            line += (
                f"; stages {r['stages']} "
                f"{check(r['stages'] == RUNNER_STAGES, f'{label} stages')}"
                f", pruned units {r['pruned_units']} (k_units "
                f"{r['k_units']}) "
                f"{check(r['pruned_units'] == r['k_units'], f'{label} sparsity')}"
                f", nonzero pruned elements {r['nonzero_pruned']} "
                f"{check(r['nonzero_pruned'] == 0, f'{label} pruned zero')}"
                f", bits [{r['bits_min']:.3f}, {r['bits_max']:.3f}]")
            if geta:
                b_l, b_u = r["bit_lower"], r["bit_upper_final"]
                ok = (b_l - 1e-3 <= r["bits_min"]
                      and r["bits_max"] <= b_u + 1e-3)
                line += (f" in [{b_l}, {b_u}] {check(ok, f'{label} bits')}"
                         f", rel_bops < 1 "
                         f"{check(r['rel_bops'] < 1.0, f'{label} rel_bops')}")
            if "sparsity" in r:
                line += (f", subnet sparsity {r['sparsity']:.4f} mean bits "
                         f"{r['mean_bits']:.3f}")
            line += (f", fake-quant launches {got} predicted {want} "
                     f"{check(got == want, f'{label} fake-quant launches')}")
        line += (f", GEMM kernels {gemm or 'none'} "
                 f"{check(not gemm, f'{label} launched a GEMM kernel')}")
        print(line, flush=True)
        info[label] = {k: v for k, v in r.items()
                       if k not in ("losses", "step_walls")}
        info[label].update(step_wall_median_s=wall, seconds=secs,
                           launches={k: v for k, v in counts.items() if v})
        torch.cuda.empty_cache()


def _args_bytes(torch, tree) -> int:
    from repro_torch.launch.dryrun import _tensors
    return sum(t.numel() * t.element_size() for t in _tensors(tree)
               if t.is_cuda)


def _dry_vs_card(torch, failures, info) -> None:
    """16b (see the module docstring)."""
    from repro_torch.configs.base import ShapeConfig

    def check(ok, what):
        if not ok:
            failures.append(f"16b {what}")
        return "ok" if ok else "FAIL"

    shapes = {"geta joint step": ShapeConfig("dry_train", DRY_SEQ, DRY_BATCH,
                                             "train"),
              "decode step": ShapeConfig("dry_decode", DECODE_S, SLOTS,
                                         "decode")}
    for label, shape in shapes.items():
        info[label] = _dry_vs_card_one(torch, label, shape, check)
        torch.cuda.empty_cache()


def _dry_vs_card_one(torch, label, shape, check) -> dict:
    """One 16b step: the meta dry run, then the same step on the card
    (every card tensor of the step is freed on return)."""
    import collections
    from repro_torch.configs import get_overrides
    from repro_torch.distributed import sharding as shlib
    from repro_torch.kernels import gemm_core as gc
    from repro_torch.kernels import meta as kmeta
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import train as T
    from repro_torch.models.transformer import LM

    mesh = meshlib.abstract_mesh((1, 1), ("data", "model"))
    t0 = time.perf_counter()
    cell, cfg, _ = DR.build_cell(ARCH, shape, mesh, depth=RUN_LAYERS,
                                 stages=("joint",))
    dry = next(iter(DR.run(cell).values()))
    dry_s = time.perf_counter() - t0
    lm = LM(cfg)
    params = lm.init(torch.Generator(device="cuda").manual_seed(0))
    qparams = lm.init_qparams(params, bits_init=8.0)
    if shape.kind == "train":
        real = meshlib.make_subset_mesh(1)
        plan = shlib.make_plan(real, overrides=dict(get_overrides(ARCH)))
        p_sh = {k: shlib.NamedSharding(real, s.spec) for k, s in
                plan.shardings(lm.param_axes(), {
                    k: tuple(v.shape) for k, v in params.items()}).items()}
        _, qasso = T.build_geta(lm, DR._DRYRUN_COMP, lr=3e-4,
                                base_optimizer=get_overrides(ARCH).get(
                                    "base_optimizer", "adamw"))
        fn, _ = T.make_sharded_geta_train_step(lm, qasso, real, params,
                                               qparams,
                                               param_shardings=p_sh)
        qstate = qasso.init(params, qparams)._replace(
            step=qasso.cfg.projection_end)
        batch = {"tokens": torch.randint(
            0, cfg.vocab, (DRY_BATCH, DRY_SEQ), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))}
        args = (params, qparams, qstate, batch)
        step = lambda: fn(params, qparams, qstate, batch)   # noqa: E731
    else:
        caches = lm.init_cache(SLOTS, DECODE_S, dtype=params[
            "embed"].dtype, device="cuda")
        token = torch.randint(0, cfg.vocab, (SLOTS, 1), device="cuda")
        pos = torch.tensor(max(PROMPT_LENS[:SLOTS]) - 1, device="cuda")
        args = (params, qparams, caches, token, pos)
        step = lambda: lm.decode_step(params, qparams,   # noqa: E731
                                      caches, token, pos)
    step()                                   # warm: the first call
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tally, by_shape = collections.Counter(), {}
    real_gemm = _gemm_shape_tally(gc, tally)
    restore = _tally_fq_shapes(by_shape)
    torch.cuda.reset_peak_memory_stats()
    try:
        t1 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        gc.gemm = real_gemm
        restore()
    peak = torch.cuda.max_memory_allocated()
    del out
    card = collections.Counter(tally)
    for key, n in by_shape.items():
        kernel, shp = key.split()
        card[(kernel.split(".")[1],
              tuple(int(d) for d in shp.split("x")))] += n
    counts = ops.launch_counts()
    card[("decode_attn", "")] += counts["decode_attn"]
    card = +card
    record = kmeta.tally(dry["launches"])
    arg_dry, arg_card = cell.arg_bytes, _args_bytes(torch, args)
    est = arg_dry + dry["temp_bytes"]
    tflops = dry["flops"] / wall / 1e12
    print(f"[16b dry run] {ARCH} {RUN_LAYERS} of 24 layers, {label}: "
          f"meta launch record {sum(record.values())} launches over "
          f"{len(record)} (kernel, variant, epilogue, K, N) keys, card "
          f"{sum(card.values())} "
          f"{check(record == card, f'{label} launch record')}"
          + ("" if record == card else
             f" (meta only {dict(record - card)}, card only "
             f"{dict(card - record)})")
          + f"; arg bytes {arg_dry} meta, {arg_card} card "
          f"{check(arg_dry == arg_card, f'{label} arg bytes')}; meta "
          f"FLOPs {dry['flops']:.4e} over the card's wall "
          f"{wall * 1e3:.3f} ms: {tflops:.2f} TFLOP/s, "
          f"{tflops * 1e12 / BF16_FLOP_PER_S:.4f} of 989e12; meta peak "
          f"estimate {est / 2**30:.2f} GiB (args "
          f"{arg_dry / 2**30:.2f} + temp {dry['temp_bytes'] / 2**30:.2f})"
          f" against max_memory_allocated {peak / 2**30:.2f} GiB, ratio "
          f"{est / peak:.3f}; meta bytes {dry['bytes']:.4e}; the dry "
          f"run took {dry_s:.1f} s", flush=True)
    return dict(launches=sum(record.values()), wall_ms=wall * 1e3,
                meta_flops=dry["flops"], tflops=tflops,
                meta_bytes=dry["bytes"], arg_bytes=arg_dry,
                temp_bytes=dry["temp_bytes"], peak_bytes=peak,
                dry_s=dry_s)


def phase_experiments(torch) -> tuple[dict, list[str]]:
    """Phase 16 (see the module docstring). Returns the runs' results and
    the dry run's comparison, and the failures."""
    failures, info = [], {"16a": {}, "16b": {}}
    _runners(torch, failures, info["16a"])
    _dry_vs_card(torch, failures, info["16b"])
    return info, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write the kernel rows and launch counts here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # cuBLAS is deterministic only with a fixed workspace; phase 7 runs
    # under torch.use_deterministic_algorithms, which requires it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # full f32 in every PyTorch matmul and convolution: plain versions and
    # library yardsticks must not round through TF32 (the kernels never do)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops

    t_phase = [time.perf_counter()]
    t_script = t_phase[0]

    def lap(label):
        now = time.perf_counter()
        print(f"[{label}] phase seconds {now - t_phase[0]:.1f}")
        t_phase[0] = now

    kind = phase_device(torch)
    phase_build()
    lap("2 build")
    timer = Timer(torch)
    rows, report, failures = phase_kernels(torch, timer)
    train_rows, train_report, train_failures = phase_train_kernels(torch,
                                                                   timer)
    rows += train_rows
    failures += train_failures
    moe_rows, moe_report, moe_kfail = phase_moe_kernels(torch, timer)
    rows += moe_rows
    failures += moe_kfail
    rec_rows, rec_report, rec_kfail = phase_rec_kernels(torch, timer)
    rows += rec_rows
    failures += rec_kfail
    front_rows, front_report, front_kfail = phase_frontend_kernels(torch,
                                                                   timer)
    rows += front_rows
    failures += front_kfail
    tp_rows, tp_report, tp_kfail = phase_tp_kernels(torch, timer)
    rows += tp_rows
    failures += tp_kfail
    del timer
    torch.cuda.empty_cache()
    failures = [f"{r['kernel']} {r}" for r in failures]
    lap("3 kernels")
    _count_captures(torch)
    smoke_counts, smoke_failures = phase_correctness(torch)
    failures += smoke_failures
    failures += phase_long(torch)
    lap("4 correctness")
    counts, outs, engine_failures, seen, full_stats = phase_engine(torch)
    failures += engine_failures
    lap("5 engine")
    paged_counts, paged_failures, paged_seen = phase_paged(torch, outs)
    failures += paged_failures
    lap("6 paged")
    train_counts, colmask_counts, train_fail, geta = phase_train(torch)
    failures += train_fail
    lap("7 train")
    pruned_counts, pruned_fail, pruned_seen = phase_pruned(torch, full_stats,
                                                           geta)
    failures += pruned_fail
    del geta
    lap("8 pruned")
    spec_counts, spec_fail, spec_seen, spec_stats = phase_spec(
        torch, full_stats, outs)
    failures += spec_fail
    lap("9 speculative")
    torch.cuda.empty_cache()
    run_counts, run_fail = phase_run_loop(torch)
    failures += run_fail
    lap("10 run loop")
    sub_counts, sub_fail = phase_substrates(torch)
    failures += sub_fail
    lap("11 substrates")
    torch.cuda.empty_cache()
    moe_counts, moe_gemms, moe_fail, moe_info = phase_moe(torch)
    failures += moe_fail
    lap("12 moe")
    torch.cuda.empty_cache()
    rec_counts, rec_gemms, rec_fail, rec_info = phase_recurrent(torch)
    failures += rec_fail
    lap("13 recurrent")
    torch.cuda.empty_cache()
    front_counts, front_gemms, front_fail, front_info = phase_frontends(torch)
    failures += front_fail
    lap("14 frontends")
    torch.cuda.empty_cache()
    tp_counts, tp_tally, tp_fail, tp_info = phase_tp(torch, outs, tp_report)
    failures += tp_fail
    lap("15 tp")
    torch.cuda.empty_cache()
    exp_info, exp_fail = phase_experiments(torch)
    failures += exp_fail
    lap("16 experiments and dry run")
    print(f"[total] script seconds {time.perf_counter() - t_script:.1f}")

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"device": kind, "rows": rows, "launches": counts,
             "paged_launches": paged_counts, "traced_kernels": seen,
             "paged_traced_kernels": paged_seen,
             "train_launches": train_counts,
             "pruned_launches": pruned_counts,
             "pruned_traced_kernels": pruned_seen,
             "colmask_launches": colmask_counts,
             "smoke_launches": smoke_counts,
             "spec_launches": spec_counts,
             "spec_traced_kernels": spec_seen,
             "run_loop_launches": run_counts,
             "substrate_launches": sub_counts,
             "moe_launches": moe_counts,
             "moe_gemm_launches": {"/".join(map(str, k)): v
                                   for k, v in moe_gemms.items()},
             "moe": {k: v for k, v in moe_info.items() if k != "fq_shapes"},
             "moe_fq_launches": {f"{d} {'x'.join(map(str, s))}": n for
                                 (d, s), n in moe_info["fq_shapes"].items()},
             "recurrent_launches": rec_counts,
             "recurrent_gemm_launches": {"/".join(map(str, k)): v
                                         for k, v in rec_gemms.items()},
             "recurrent": rec_info,
             "frontend_launches": front_counts,
             "frontend_gemm_launches": {"/".join(map(str, k)): v
                                        for k, v in front_gemms.items()},
             "frontends": front_info,
             "tp_launches": tp_counts,
             "tp_kernel_launches": {"/".join(map(str, k)): v
                                    for k, v in tp_tally.items()},
             "tp": tp_info,
             "experiments": exp_info,
             "trace_takes": _TRACE_TAKES,
             "spec_engines": {f"{t}/{d}": {
                 k: v for k, v in st.items()
                 if k not in ("base_logits", "base_toks", "base_stats")}
                 for (t, d), st in spec_stats.items()}},
            indent=1, default=str))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    attn = ("src/repro_torch/kernels/csrc/decode_attn.cu",
            "src/repro/kernels/decode_attn.py:63")
    paged = ("src/repro_torch/kernels/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn.py:238")
    gemm = ("src/repro_torch/kernels/csrc/gemm_core.cu",
            "src/repro/kernels/gemm_core.py:127")
    kernels = []
    for name in ("gemm_core.fake_quant_rhs", "gemm_core.dequant",
                 "gemm_core.unpack_dequant", "decode_attn", *PAGED_KERNELS):
        row = report[name]
        src, replaces = (paged if name in PAGED_KERNELS else
                         attn if name == "decode_attn" else gemm)
        launches = (paged_counts if name in PAGED_KERNELS else counts)[name]
        # the device kernels of phases 5-6's traced drains (graph replays
        # included), which the host counts see only at capture
        device = (paged_seen[f"flash_decode_split.{name.split('.')[1]}"]
                  if name in PAGED_KERNELS else
                  seen["flash_decode_split"] if name == "decode_attn" else
                  seen[f"gemm_small_m.{name.split('.')[1]}"]
                  + paged_seen[f"gemm_small_m.{name.split('.')[1]}"])
        shape = (f"M={row['M']} K={row['K']} N={row['N']}"
                 + (" bits=4" if "unpack" in name else "")
                 if name.startswith("gemm") else
                 f"B={row['B']} S={row['S']} KVh={row['KVh']} g={row['g']} "
                 f"dh={row['dh']}" + (f" P={row['P']}" if "P" in row else "")
                 + f" R={row['R']} q bf16, pos int64")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "traced_device_launches": device,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": shape, **({"variant": row["variant"]}
                               if "variant" in row else {}),
            # device kernels per call, read from a profiler trace
            "kernels_per_launch": row["kernels_per_call"],
            **({"rows_per_split_ms": row["rows_ms"],
                "at_S4096": row["at_S4096"]} if "at_S4096" in row else {})})
    # the decode GEMMs at sparsity 0.3's widths, launched by phase 8
    for K, N in PRUNED_GEMMS:
        for label in PRUNED_EPIS:
            base = _report_name(label)
            row = report[f"{base}.pruned.{K}x{N}"]
            epi = base.split(".")[1]
            kernels.append({
                "name": f"{base}.pruned.{K}x{N}", "route": "cuda",
                "source": gemm[0], "replaces": gemm[1],
                "launches": pruned_counts[base],
                "traced_device_launches": pruned_seen[f"gemm_small_m.{epi}"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"M={row['M']} K={K} N={N}"
                         + (" bits=4" if "unpack" in base else "")
                         + " rows padded to 16 bytes",
                "variant": row["variant"],
                "kernels_per_launch": row["kernels_per_call"]})
    # the verify heights, launched by phase 9's round graphs: a row's
    # launches are the captures of its draft length's graphs (host counts),
    # `replayed_launches` the kernels their replays ran
    for label, target in (("fake_quant_rhs", "dense"),
                          ("dequant", "compressed")):
        for M in VERIFY_MS:
            k = M // SLOTS - 1
            K, N = REPORT_SHAPE[1:]
            row = report[f"gemm_core.{label}.verify.M{M}.{K}x{N}"]
            engines = [st for (t, _), st in spec_stats.items()
                       if t == target]
            per_graph = [st["graph_launches"][k].get("gemm_core.tc", 0)
                         for st in engines]
            kernels.append({
                "name": f"gemm_core.{label}.verify.M{M}", "route": "cuda",
                "source": gemm[0], "replaces": gemm[1],
                "launches": sum(per_graph),
                "replayed_launches": sum(
                    n * st["replays"].get(k, 0)
                    for n, st in zip(per_graph, engines)),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"M={M} K={K} N={N} (verify, k={k})",
                "variant": row["variant"],
                "block_height_ms": row["heights"]})
    fq_src = "src/repro_torch/kernels/csrc/fake_quant.cu"
    train_src = {"fake_quant.fwd": (fq_src,
                                    "src/repro/kernels/fake_quant.py:31"),
                 "fake_quant.bwd": (fq_src,
                                    "src/repro/kernels/fake_quant.py:45")}
    for name in (*TRAIN_REPORT, "gemm_core.simt.fake_quant_rhs"):
        row = train_report[name]
        src, replaces = train_src.get(name, gemm)
        key = row["kernel"]
        shape = (f"{row['w']} {row['shape'][0]}x{row['shape'][1]} bf16 "
                 f"t={row['t']}" if name.startswith("fake_quant") else
                 f"M={row['M']} K={row['K']} N={row['N']} "
                 f"{row.get('layout', 'x,w')} t={row['t']} out {row['out']}")
        # col_mask launches only in phase 7's .colmask step; phase 7 checks
        # that every training GEMM took the tensor-core variant; the SIMT
        # variant launches only for f32 x, in phase 4's smoke config runs
        launches = (smoke_counts["gemm_core.simt"] if "simt" in name else
                    (colmask_counts if "col_mask" in key else
                     train_counts)[key])
        extra = {}
        t85 = {"gemm_core.tc.fake_quant_rhs": "at_t0.85",
               "gemm_core.simt.fake_quant_rhs": "simt_at_t0.85"}.get(name)
        if t85 is not None:
            extra["at_t0.85"] = {k: train_report[t85][k] for k in (
                "ms", "plain_ms", "library_ms", "max_abs_err")}
        if name.startswith("fake_quant"):
            t85 = train_report[name + ".at_t0.85"]
            extra["at_t0.85"] = {k: t85[k] for k in (
                "ms", "plain_ms", "max_abs_err", "kernels_per_call")}
            # device kernels per call, read from a profiler trace
            extra["kernels_per_launch"] = row["kernels_per_call"]
        if "heights" in row:
            extra["block_height_ms"] = row["heights"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": shape, **({"variant": row["variant"]}
                               if "variant" in row else {}), **extra})
    # the fake-quant kernels at phase 11's VGG7 shapes (f32): launches are
    # phase 11's VGG7 launches at the row's shape (conv5's weight site; the
    # relu0 and relu1 activation sites), over its len(SUB_STAGES) steps
    for base in ("fake_quant.fwd", "fake_quant.bwd"):
        for label, shape in CNN_FQ_SHAPES.items():
            row = train_report[f"{base}.{label}"]
            t85 = train_report[f"{base}.{label}.at_t0.85"]
            n = sub_counts["vgg7"]["by_shape"].get(
                f"{base} {'x'.join(map(str, shape))}", 0)
            kernels.append({
                "name": f"{base}.{label}", "route": "cuda", "source": fq_src,
                "replaces": train_src[base][1], "launches": n,
                "launches_per_step": n / len(SUB_STAGES),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"{label} {'x'.join(map(str, shape))} f32 t=1",
                "at_t0.85": {k: t85[k] for k in (
                    "ms", "plain_ms", "max_abs_err", "kernels_per_call")},
                "kernels_per_launch": row["kernels_per_call"]})
    # grok-1's shapes (phase 3's rows), with phase 12's launches at each
    # row's shape: the GEMMs' host counts in 12a-c by (variant, epilogue,
    # K, N) (a graph's calls once, at capture), decode attention's over
    # 12a-c, the fake-quant kernels' by input shape over 12a-d
    from repro_torch.kernels import gemm_core as gc
    for M, K, N, epis, per in MOE_GEMMS:
        for label in epis:
            base = _report_name(label)
            row = moe_report[f"{base}.grok.M{M}.{K}x{N}"]
            var = gc.variant(M, torch.bfloat16)
            kernels.append({
                "name": f"{base}.grok.M{M}.{K}x{N}", "route": "cuda",
                "source": gemm[0], "replaces": gemm[1],
                "launches": moe_gemms.get((var, label, K, N), 0),
                ("launches_per_prefill" if M > SLOTS else
                 "launches_per_decode_step"): per,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"M={M} K={K} N={N} ({MOE_ARCH})",
                "variant": row["variant"],
                **({"block_height_ms": row["heights"]} if "heights" in row
                   else {"kernels_per_launch": row.get("kernels_per_call")})})
    row = moe_report["decode_attn.grok"]
    kernels.append({
        "name": "decode_attn.grok", "route": "cuda", "source": attn[0],
        "replaces": attn[1], "launches": moe_counts["decode_attn"],
        "launches_per_decode_step": MOE_LAYERS,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": f"B={row['B']} S={row['S']} KVh={row['KVh']} g={row['g']} "
                 f"dh={row['dh']} R={row['R']} q bf16, pos int64 "
                 f"({MOE_ARCH})",
        "kernels_per_launch": row["kernels_per_call"]})
    for base in ("fake_quant.fwd", "fake_quant.bwd"):
        for label, shape in MOE_STACKS.items():
            row = moe_report[f"{base}.{label}"]
            kernels.append({
                "name": f"{base}.{label}", "route": "cuda", "source": fq_src,
                "replaces": train_src[base][1],
                "launches": moe_info["fq_shapes"].get(
                    (base.split(".")[1], shape), 0),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None,
                "shape": f"{label} {'x'.join(map(str, shape))} bf16 t=1 "
                         f"({row['numel']} elements)",
                "kernels_per_launch": row["kernels_per_call"]})
    # the recurrent mixers' shapes (phase 3's rows), with phase 13's
    # launches at each row's (variant, epilogue, K, N): the host counts of
    # 13a-d (a graph's calls once, at capture)
    for model, M, K, N, epis, xdt, strided in REC_GEMMS:
        for label in epis:
            name = _rec_gemm_name(model, M, K, N, label)
            row = rec_report[name]
            epi = _report_name(label).split(".")[1]
            var = gc.variant(M, torch.bfloat16 if xdt == "bf16"
                             else torch.float32)
            kernels.append({
                "name": name, "route": "cuda", "source": gemm[0],
                "replaces": gemm[1],
                "launches": rec_gemms.get((var, epi, K, N), 0),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"M={M} K={K} N={N} x {xdt}"
                         + (" (a strided view, rows 544 apart)" if strided
                            else "")
                         + (" bits=4" if "unpack" in label else "")
                         + f" ({REC_ARCH if model == 'rwkv6' else HYB_ARCH})",
                "variant": row["variant"],
                **({"block_height_ms": row["heights"]} if "heights" in row
                   else {"kernels_per_launch": row.get("kernels_per_call")})})
    # phase 14's shapes (phase 3's rows), with phase 14's launches at each
    # row's (variant, epilogue, K, N) over 14a-d (host counts: a graph's
    # calls once, at capture), and decode attention's in 14a (musicgen's
    # shape) and 14d (the ring)
    for M, K, N, epis in FRONT_GEMMS:
        for label in epis:
            name = _front_gemm_name(M, K, N, label)
            row = front_report[name]
            epi = _report_name(label).split(".")[1]
            var = gc.variant(M, torch.bfloat16)
            kernels.append({
                "name": name, "route": "cuda", "source": gemm[0],
                "replaces": gemm[1],
                "launches": front_gemms.get((var, epi, K, N), 0),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"M={M} K={K} N={N} ({VLM_ARCH})",
                "variant": row["variant"],
                **({"block_height_ms": row["heights"]} if "heights" in row
                   else {"kernels_per_launch": row.get("kernels_per_call")})})
    for shape_of, sub in (("musicgen", "14a"), ("ring", "14d")):
        row = front_report[f"decode_attn.{shape_of}"]
        what = (AUDIO_ARCH if shape_of == "musicgen"
                else f"a {WINDOW}-row ring past its end")
        kernels.append({
            "name": f"decode_attn.{shape_of}", "route": "cuda",
            "source": attn[0], "replaces": attn[1],
            "launches": front_info[sub]["decode_attn"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": f"B={row['B']} S={row['S']} KVh={row['KVh']} "
                     f"g={row['g']} dh={row['dh']} R={row['R']} q bf16, pos "
                     f"int64 ({what})",
            "kernels_per_launch": row["kernels_per_call"]})
    kernels += _tp_kernel_rows(tp_report, tp_tally, gemm, attn, paged)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
