"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a). Phases, each printing its own lines:

0. device: refuse to run without CUDA; print the card's name and power
   limit (nvidia-smi), torch and CUDA versions, the SM clock and the
   highest SM clock; turn TF32 off.
1. build: compile tokenreduction_tpu_torch/csrc/*.cu with nvcc into
   build/tokenreduction_tpu_torch/<source hash>/; print each kernel
   variant's registers and spills (ptxas), by its demangled name, and the
   bf16 GEMM's tile, stages and dynamic shared memory a block, as the
   library reports them (tr_gemm_sm90_config), the sm_90a
   attention's dynamic shared memory a block at each main-path width
   and of its rectangular variant at ATS's (M, N) pairs
   (tr_attention_sm90_smem), the fp32 tensor-core kernels' plans as the
   library reports them (_build.gemm_tf32_config,
   _build.gemm_tf32_bwd_config: the backward GEMM's tile, rings and
   shared memory a block for dY . W and the weight gradient, and
   _build.attention_tf32_plan at each main-path width and 256: the square
   forward's and the backward's shared memory, and the rectangular
   forward's at ATS's (M, N) pairs), the LayerNorm backward's, and the
   kernel tools' joint attention's and chunked MLP's (tr_attn_joint_smem,
   tr_mlp_chunked_config: rows a block, hidden units a slice) and the
   attention prototypes' (tr_proto_attn_smem for each arrangement,
   tr_proto_attn_bwd_smem, at phase 10's widths); and,
   from the built library's SASS (cuobjdump), a TF32 tensor-core
   instruction (HGMMA or HMMA .TF32) in every variant of the fp32 GEMMs
   (forward and backward), the fp32 forward attention (square and
   rectangular) and the fp32 attention backward, or it fails.
2. kernels: each kernel counterpart against its plain PyTorch version on
   the same CUDA tensors at the main path's widths, fp32 at B=32 (bound
   1e-4 of max|plain|) and bf16 at B=256 (bound 2e-2 of max|plain|), with
   CUDA-event times (median of 20 runs). In bf16 the block's output is
   dominated by its residual, so each bf16 launch is also held alone,
   with no residual, against its plain version at B=256, relative to that
   tensor's own max: LayerNorm (bf16, fp32 and gathered rows), the qkv
   and fc1+GELU GEMMs and the attention's merged heads within 1e-2 (one
   to three bf16 ulps of the max, where two fp32 sums round apart); the
   attention's fp32 row0 and colsum and the proj and fc2 GEMMs with fp32
   output within 1e-4.
   ToMe's eval counterparts: fused_block_attention with a per-key bias
   (log sizes) and the head-mean keys, and fused_mlp_residual, at ToMe@0.7's
   widths 197, 138, 97, 68.
   ATS's: fused_block_attention with a validity mask at the widths of
   ATS@0.7 and @0.25 (197 ... 4), fused_attention and fused_attention_qkv
   with the mask at 197, 138, 97, 68, and fused_rect_attention and
   fused_rect_block at their (kept rows M, keys N) pairs 138x197, 97x138,
   68x97, 50x197, 13x50, 4x13; each mask has tokens off (fully masked
   query rows), each kept-row set pads (CLS copies) and a dead slot. Their
   bf16 launches alone: the masked attention (eval and normalised-P), the
   rectangular attention and the out projection with the gathered
   residual.
   DyViT's: fused_block_attention with the idx prologue at DyViT@0.7's
   (N -> K) = 197->138, 138->97, 97->68, the kept ids unsorted with CLS.
   EViT's: fused_mlp_gather_residual over the N tokens and the fused row
   appended as row N, (N + 1 -> K) = 198->139, 140->98, 99->69 (CLS, the
   kept patches unsorted, the fused row).
   Heuristic's: attention_core_train with the validity mask at N=197, with
   heuristic's block-3 and block-9 masks (184 and 12 of 196 patches valid:
   most query rows fully masked), forward and every gradient; its bf16
   masked backward launch alone, with and without the by-products'
   cotangents.
   Training kernels (attend_branch_train, mlp_branch, attention_core_train):
   forward outputs and every gradient, with non-zero row0 (and, for the
   core, colsum) cotangents, against the plain forward and the plain
   hand-written backward at the training widths, fp32 at B=32 (1e-4) and
   bf16 at B=256 (2e-2), each tensor of its own max|plain|, also at the
   distilled DeiT-S's N=198 (CLS, dist token, 196 patches); the DyViT
   teacher's fused_full_block in fp32 at B=256, N=197 (1e-4), with its
   bound at the fp32 rate; each new bf16
   launch alone (gemm with W untransposed, with the GELU' factor and
   column sums, gemm_wgrad, short_attention_bwd, layer_norm_bwd, the
   training attention forward; the biased attention forward, head_mean_keys
   and the biased backward with its colsum cotangent and dbias over
   [B, H, N, hd] views) as above.
   Then each launch of the bf16 GEMM (csrc/gemm_sm90.cu: TMA, mbarrier,
   wgmma) alone at every shape of a DeiT-S block, B=256 (M = 50,432 rows)
   and B=32 (M = 6304: a ragged last row tile, and for the weight
   gradient rows that are no multiple of its 64-row K step): the
   forward's qkv, proj + residual, fc1 + GELU (also with GELU' out) and
   fc2 + residual; the backward's dY . W of each (fp32 out where LN's
   backward reads it, fc2's with the GELU' factor and the column sums);
   the four weight gradients (with the bias sums); and topk@0.25's last
   stage at B=256 (M = 1024, 8 row tiles), its forward's products and fc2
   with the residual gathered as the K=4 gathered MLP reads it. Each
   output is held to 1e-2 of its own max (bf16) or 1e-4 (fp32), with its
   time per launch (ten back-to-back launches between two events),
   TFLOP/s (which must not pass the dense peak at the card's highest SM
   clock), its bound and,
   where one PyTorch call computes the same function (F.linear, matmul,
   matmul(dy.t(), x)), that call's time.
   Last, each launch of the sm_90a attention (csrc/attention_sm90.cu)
   alone at B=256 and N = 197, 138, 97, 68 (topk@0.7's widths), 50, 13,
   4 (topk@0.25's) and at B=32, N=197: the eval forward without and with
   row0 and colsum, with ToMe's bias, with a validity mask, and the
   training branch's normalised-P forward with its row statistics; the
   backward of the branch (row0 cotangent), of ToMe's core (bias, colsum
   cotangent, dbias) and of a masked core; and the rectangular attention
   (the RECT variant of the same forward: query rows gathered by
   cp.async) at ATS's (M, N), whose slots padded with the CLS row must
   equal the CLS slot bit for bit and whose dead slot (a fully masked
   row) must be the mean of the values within 1e-2. Each output is
   held to 1e-2 of its own max (bf16) or 1e-4 (fp32), beside its time per
   launch, TFLOP/s (failing above the dense ceiling), its bound and
   SDPA's time on the same q, k, v (the output alone; the bias or the
   pair mask as a float mask; its backward alone through autograd; the
   kept query rows gathered first for the rectangular one).
   Then the LayerNorm backward (layer_norm_bwd, csrc/ln_gemm.cu) alone, in
   bf16 and fp32, at B=256 and N = 197, 138, 97, 68, at B=32, N=197 (a
   ragged last band) and at DeiT-Ti's K = 192 (the general instance): dx
   within 1e-2 (bf16) or 1e-4 (fp32) of its own max, d gamma and d beta
   likewise, and a second launch bit-equal to the first; its time per
   launch beside its bound, the plain version's time and
   aten.native_layer_norm_backward's. Then head_mean_keys
   (csrc/short_attention.cu: 16-byte lanes, the heads' loads unrolled at
   3, 6 and 12 heads) at every ToMe@0.7 width, B=256 and B=32, bf16 and
   fp32, bit-equal to head_mean_keys_ref; and sum_partials_many
   (csrc/ln_gemm.cu: every partial sum of a branch backward in one launch)
   on the job sets that the attention and MLP branch backwards hand it at
   B=256, N=197 and N=68 (recorded from one backward of each), on eight
   jobs, on one job whose width is no multiple of 4 and on nine jobs (two
   launches), bit-equal to one single-job launch per job and to the plain
   z-order sum; each with its time per launch by CUDA events and by
   torch.profiler's device time (below about 0.04 ms the event time is the
   host's), its bound, and the library calls' (the head mean of the packed
   keys; one part.sum(0) a job), each timed call on its own copies of the
   inputs, cycled through more than twice the card's L2 (cold), so that it
   reads from HBM as its bound counts. Last, the other hand-written
   kernels alone at B=256 (cold likewise, as is the layer_norm record),
   their time per launch beside their bound and
   the one PyTorch call computing the same function: layer_norm of bf16
   rows (F.layer_norm), fp32 rows and gathered rows, sum_partials at the
   LayerNorm backward's [bands, 2K] (and its former [264, 2K]) and at each
   weight and bias gradient's [splits, L] (part.sum(0)), head_mean_keys at ToMe@0.7's
   widths (the head mean of the packed keys); after phase 5, each with its
   launches on the main path (the sums': of the batched launches).
   Then the fp32 kernels on the tensor cores (3xTF32), each launch alone
   at B=256 and B=32, N=197: the forward GEMM (csrc/gemm_tf32_sm90.cu) at
   qkv, proj + residual, fc1 + GELU (also with GELU' out, the training
   forward's), fc2 + residual and fc2 with #3's gathered residual (197 -> 138 and 13 -> 4 rows), and the square
   attention (short_attention_tf32_kernel) without by-products, with row0
   and colsum, with ToMe's bias and with a validity mask, the attention
   backward (short_attention_bwd_tf32_kernel) without options, with the
   branch's row0 cotangent, with ToMe's bias, both cotangents and dbias,
   with a validity mask (fully masked query rows) and with all of them,
   and the rectangular attention (the RECT variant) at ATS's (M, N) pairs
   and 80x50 (B=256) and 138x197 (B=32), its CLS pads bit-equal to the
   CLS slot and its dead slot the values' mean: each output within 1e-4
   of its own max|plain| (a backward's and a rectangular forward's second
   launch bit-equal to the first), beside its time per launch, cuBLAS
   SGEMM's (F.linear) or SDPA's in fp32 (TF32 off; the backward's SDPA's
   backward alone, the rectangular one's on the gathered rows), the
   3xTF32 bound and the FMA bound. Last the fp32 backward's GEMM layouts
   (csrc/gemm_tf32_bwd_sm90.cu, 3xTF32) at B=256 and B=32: the four
   dY . W products and the four weight gradients (with their bias sums
   and the partial sums' launch), each within 1e-4 of its own max|plain|
   and a second launch bit-equal to the first, beside cuBLAS SGEMM and
   both bounds. The fp32 attention backward's variants with the row0 or
   colsum cotangent have no library call (SDPA returns no probabilities,
   so no cotangent of them enters its backward): beside SDPA's backward
   without them, the eager fp32 composition (the plain version) is timed;
   and the DyViT teacher's fp32 fused_full_block beside the eager fp32
   composition of library calls.
   Beside each counterpart's time: its bound (bytes or operations at the
   H100's peak rates: fp32 products as 3xTF32) and the eager bf16
   composition of library calls
   (F.layer_norm, F.linear, scaled_dot_product_attention with the bias and
   the pair mask as its float mask, the kept query rows gathered first for
   the rectangular attention, the kept rows gathered first for the idx
   prologue, autograd for the backward) computing the same function.
3. models: DeiT-S dense, topk@0.7, topk@0.25, ToMe@0.7, ATS@0.7 (loc 3 6
   9, widths 197 -> 138 -> 97 -> 68), heuristic (loc 3 6 9: masks at
   blocks 3-11, every block at 197) and DyViT@0.7 (197 -> 138 -> 97 -> 68)
   at
   full width with seeded weights on the card (kernels) against the same
   model on the CPU (plain versions), with the launch counts of one
   forward. Viz mode is off (it pins the plain composition): the
   decisions are recorded through hooks (record_decisions). fp32 at B=8: logits within 1e-4 of max|CPU|, the same top-1,
   the same kept ids and equal Assignment_Maps. bf16 at B=32: top-1
   agreement at least 0.9, at least 0.9 of the kept ids in the CPU's kept
   set, ToMe's share of equal Assignment_Maps entries (bound set from a
   measured run), two ToMe forwards with the same logits, and dense logits
   within 2e-2 of max|CPU|. Random weights make near-uniform attention, so
   the top-k scores lie closer than a bf16 ulp and a few kept ids differ;
   the reducing models' bf16 logits, which then see other tokens, are
   reported only. Kept_Tokens flips (same id at the same rank) are
   reported. ATS: fp32 Kept_Tokens equal to the CPU's; bf16 two forwards
   with the same logits and Kept_Tokens, the share of Kept_Tokens equal to
   the CPU's and the top-1 agreement reported only (inverse-transform
   sampling flips at the smallest score drift). Heuristic: Kept_Tokens_Abs
   equal, and its logits held like dense's in bf16 too (no data-dependent
   decision). DyViT: its kept tokens, as absolute patch ids, the CPU's in
   fp32 (Kept_Tokens ids that differ in place, a swap of two near-tied
   kept tokens, reported); in bf16 the CPU model takes the card's
   predictor scores (random weights make them tie in bf16) and the logits
   are held like dense's. EViT@0.7, k-medoids@0.7, DPC-KNN@0.7 (no density
   noise on either device), Sinkhorn@0.7, PatchMerger@0.7 and SiT@0.7
   likewise, their decisions recorded through hooks (EViT's Kept_Tokens
   with the fused token's -1 and Fusion_Assign; k-medoids' and DPC-KNN's
   centre ids and assignments, whose CPU model takes the card's ids, so
   that the rest of the forward sees the same tokens; the soft trio's
   Assignment_Maps, the argmax of each soft assignment). fp32: EViT's
   decisions equal; k-medoids' and DPC-KNN's at least 0.99 equal to the
   CPU's own; the soft trio's soft assignments within 1e-4 of max|CPU|
   (PatchMerger's 5e-3: its unscaled logits) and their Assignment_Maps
   equal but where the CPU's soft values tie within 1e-5 of the map's max
   (random weights make the first stage average the tokens nearly alike,
   and the later stages' soft maps uniform to the last fp32 bits). bf16:
   top-1 agreement and shares of equal decisions with bounds set from
   measured runs (CLUSTER_BF16).
   Then, fp32 B=8, each reducing model in viz mode on the card against the
   same on the CPU: no kernel may launch (the viz pin), and the logits and
   the artifacts' ids equal in place are reported; and dense DeiT-S on a
   272-pixel input (N = 290, wider than the fused full block and the
   single-pass attention): 12 fused_block_attention launches on the wide
   fp32 attention (12 attention_wide_tf32) and 12 fused_mlp_residual,
   nothing else, and the logits held like dense's.
   Training, drop_path 0: the loss and every gradient of dense, topk@0.7,
   ToMe@0.7 and heuristic on the card against the CPU, fp32 at B=8 (1e-4
   of each leaf's max|CPU|, the same kept ids and merges) and bf16 amp at
   B=32 (bounds set from measured runs; heuristic's gradients against the
   CPU's fp32 ones, FP32_GRAD_REF), and the launches of one train
   step: 12 forwards and 12 backwards of each training branch (ToMe: the
   attention branch in blocks 0-3, the attention core in blocks 4-11;
   heuristic: the branch in blocks 0-2, the masked core in 3-11). In fp32
   only, EViT@0.7 (its fused token's gradient through the attention
   branch's CLS row: 12 attention branches) and k-medoids@0.7 (its
   colsum blocks 2, 5, 8 through the attention core; its CPU model takes
   the card's medoids) the same way; and Sinkhorn@0.7's loss and
   gradients, then one step with project_sinkhorn whose cluster vectors
   must have rows of unit norm.
   Then dense with drop_rate and attn_drop_rate 0.1: a bf16 amp train
   step from a seeded CUDA generator, twice from the same start, must give
   the same loss and parameters bit for bit (another seed another loss).
   Last, DyViT's training and the teachers, fp32 B=8 against the CPU: the
   DyViT teacher's logits and post-norm patch tokens (12 fp32
   fused_full_block launches) and RegNetY-160's logits at its published
   widths, within 1e-4 of max|CPU| with the same top-1; the loss
   (train/loop.py's build_loss_fn) and every gradient of DyViT@0.7's
   training forward without and with dyvit_distill (the CPU model takes
   the card's Gumbel uniforms, GumbelReplay; the decisions equal in
   place), and of DeiT-S distilled against RegNetY-160, soft and hard,
   within 1e-4; the launches of one train step (DyViT: 12 mlp_branch
   forwards and 12 backwards, no attend_branch_train, 12 fused_full_block
   in the teacher; the distilled DeiT-S: both branches at N=198); and
   DyViT@0.7 with its teacher in bf16 amp at B=32: the loss within 2e-2,
   at least 0.99 of the Gumbel decisions equal to the CPU's (bf16 scores
   tie within an ulp; bound from a measured run), gradients reported.
4. serve: 5 batches of 256 bf16 images through each model (ATS@0.7,
   heuristic, DyViT@0.7, EViT@0.7 and the cluster family included;
   DPC-KNN's density noise from a seeded CUDA generator); outputs must be
   finite; img/s over batches 2-5. Then, not counted, one forward each of
   ATS@0.7, heuristic, DyViT@0.7, EViT@0.7 and the cluster family that
   must not wait for the card (no host synchronisation that PyTorch
   reports), and a torch.profiler window of two forwards of ATS@0.7,
   heuristic, k-medoids@0.7 and DPC-KNN@0.7: the device's busy share and
   its time per forward by kernel; and, for the cluster family, the
   device time of the clustering between the blocks against the whole
   forward (CUDA events around each clustering call, 3 forwards). Last,
   validate's default precision: 5 batches of 256 fp32 images through
   dense, topk@0.7 and ATS@0.7, img/s over batches 2-5, each forward's
   48 fp32 GEMMs and 12 fp32 attentions on the tensor-core kernels
   (ATS's: 9 square and 3 rectangular ones), each model a path of its
   own, its counts set to 0 just before and read just after.
5. train: bench.py's train step for dense, topk@0.7, ToMe@0.7,
   heuristic, EViT@0.7 and k-medoids@0.7 -- b256,
   amp, drop_path 0.1 from a seeded CUDA generator, grouped AdamW lr 1e-3
   with backbone_lr_scale 0.01, clip 1.0, EMA 0.99996, label smoothing 0.1
   -- 8 steps on seeded random images and labels; the losses must be
   finite and the params must move; ms/step and img/s over steps 3-8; each
   model's sum launches, one in each branch backward (at most 2 a block:
   dense and topk@0.7 24 a step), are required. Then
   the same steps of the first four with the eager bf16 library
   composition in place of the three training counterparts, and last a
   torch.profiler window of two steps each of dense, topk@0.7, ToMe@0.7
   and heuristic: the device's busy share and its time per step by
   kernel. Each train line gives the run's peak memory allocated. The
   same 8 steps of the two distillation cells: DyViT@0.7 with
   dyvit_distill and its fp32 teacher, DeiT-S distilled with a
   RegNetY-160 hard teacher (train/loop.py's loss; the teacher's forward
   timed by CUDA events); their profiled windows also break the device
   time down: the port's kernels, the teacher's forward, and DyViT's 12
   policy attention halves (one timed alone, forward and backward, at
   b256); DyViT's window must show the teacher on the tensor-core kernels
   and no fp32 backward GEMM. Last, the JAX CLI's default precision: 8
   fp32 train steps of topk@0.7 at b256 (no amp), a path of its own, with
   12 tensor-core attention backward launches a step (and 48 + 48
   backward GEMM layouts, 48 forward GEMMs and 12 attentions, all on the
   tensor cores) required, and a torch.profiler window of two such steps
   (the device's time by kernel).

6. eval and artifacts: the eval CLIs as users run them, on port
   checkpoints (<run>/best_checkpoint/{meta.json, tree.pt}) written from
   seeded DeiT-S weights at full width (dense, topk@0.7, EViT@0.7,
   ToMe@0.7, DPC-KNN@0.7, heuristic; reduction_loc 3 6 9), over
   --dataset synthetic --synthetic-n 512 -b 256 at 224 px. It prints
   first whether Pillow and pandas import, and which host path runs:
   the data pipeline's Loader and run_table's scan when they do, else
   numpy batches made from a seed (the same validate and extract code
   below the Loader) and a CSV written with the csv module. Then:
   validate_dirs --no-viz_mode (fp32 on the tensor-core kernels: each
   row's gemm_tf32 and attention_tf32 launches > 0, no bf16 launch),
   validate --use_amp of topk@0.7 (the bf16 kernels, each counterpart's
   launches as phase 4's), validate_dirs in viz mode (no launch in a viz
   row; the dense row, without viz as validate_dirs has it, runs the fp32
   kernels again) and extract_cls_features_dirs (no launch; (384, 512)
   .npy files); each run's counts set to 0 just before and read just
   after. Each run's fp32 predictions must equal its viz-mode ones (the
   plain fp32 composition, TF32 off; dense's from validate --viz_mode,
   which writes its predictions JSON), losses within 1e-4 relative; a
   CPU viz run and extraction of the first 16 images must agree with
   the card's: decisions equal (DPC-KNN's at least 0.99; topk's and
   EViT's but where the CPU's scores of the two tokens tie,
   EVAL_SCORE_TIE), features within 1e-4 of max|CPU|. Each run's validate img/s end to end (checkpoint load and
   host data path included) prints beside its forward-only img/s inside
   that run and phase 4's img/s of the same model.

7. train CLI: the port's train CLI as users run it
   (train/train_cli.py -> train/loop.py::run_training) at DeiT-S's full
   width, topk@0.7 (loc 3 6 9), 224 px, --dataset synthetic. First the
   --no-train-mode repair: one step of topk@0.7 in eval mode under
   autograd, fp32 B=8, launches no kernel (the plain composition; the
   eval kernels have no backward), its loss and every gradient within
   1e-4 of max|CPU|, and the same forward under torch.no_grad() takes the
   kernels (phase 4's count). Then the JAX CLI's default recipe (mixup
   0.8, cutmix 1.0, label smoothing 0.1, drop-path 0.1, EMA, the grouped
   AdamW and the cosine schedule), in amp and in fp32: b256 over 512
   images (RASampler: 2 steps an epoch), Loader worker processes as the
   cores allow, two epochs, then --resume from the checkpoint dir for a
   third, each run a path of its own (counts set to 0 just before, read
   just after): finite losses; attend_branch_train and mlp_branch
   launched as phase 5 counts them a step times the steps; the eval in the
   loop (the params' and the EMA's, fp32) on the eval counterparts as
   phase 4 counts a topk@0.7 forward times the forwards, on the
   tensor-core kernels (gemm_tf32, attention_tf32); amp training on the
   bf16 GEMM, fp32 training on the fp32 backward's kernels (48 + 12 a
   step); best_checkpoint/{tree.pt, meta.json} written; the resumed run
   logging epoch 2 only. Each run prints its train img/s end to end
   (log.txt's images_per_sec) beside phase 5's step img/s of the same
   cell, its eval seconds and its checkpoint seconds (save() on the main
   thread, the background writes). Then the port's validate on the card
   reads the amp run's best_checkpoint (256 images, the fp32 tensor-core
   kernels). Last, the card against the CPU (the port on both): one epoch
   at b16 over 32 images, fp32, drop-path 0, mixup and cutmix on, from
   one .pth of seeded weights (--finetune): the first step's loss and the
   epoch's test loss within 1e-4 relative, the later steps reported.

8. the rest of the train CLI's flags, at DeiT-S's full width. (a) The
   train CLI with --device_aug (data/device_aug.py: the Loader copies
   uint8 squares of 256 px, the step crops, flips, RandAugments,
   normalises and erases them on the card): topk@0.7, b256 over 512
   synthetic images, amp and fp32, two epochs each with the eval in the
   loop, each run a path of its own with phase 7's launch checks; each
   prints its img/s an epoch beside phase 7's host path in the same call
   and the training branches' launches a step (the aug is PyTorch on the
   card and adds no kernel). Then the aug's own ms for a b256 batch (CUDA
   events; it must launch no kernel of the port) beside the Loader's ms
   a batch on the host path and on the uint8 path. (b) The aug on the
   card against the CPU on the same uint8 inputs at fixed parameters:
   crop, resize and flip and the eval transform within 1e-4 of 255; the
   LUT ops (autocontrast, equalize, invert, posterize, solarize,
   solarize-add) equal; the enhance ops within 1e-4 of 255; the five
   geometric ops at most 1 level apart on at most 0.1% of the values;
   the whole aug from one seed twice bitwise equal, fp32
   [B, 3, 224, 224] on the card, within 0..255 without erasing. (c) Every
   --opt name: three updates of topk@0.7's params (seeded noise on every
   leaf) from the gradients of three fp32 B=32 batches, on the card and
   on the CPU, within 1e-5 of each leaf's max|CPU| (adam, nadam,
   adabelief and adahessian: at most 1e-4 of the params beyond it, each
   within 1e-2, as fp32 itself is against fp64 there: OPT_ILL);
   AdaHessian's Hutchinson diagonal at B=8 on the plain composition
   launches no kernel and agrees with the CPU's on the same probe within
   1e-4 of max|CPU|. (d) --finetune of a seeded Brain-Flax .npz that the
   phase writes, topk@0.7 at DeiT-S width, on the card and the CPU
   (train/loop.py::_load_finetune): every parameter as written, the fp32
   logits within 1e-4 of max|CPU|. Each line prints its seconds.

9. the kernel tools (tokenreduction_tpu_torch/tools/), on no path of the
   models, bf16 at B=256 and DeiT-S width: the joint attention
   (tune_kernels.attn_joint, csrc/attn_joint.cu: each (image, head)'s
   qkv product fused into its attention) and the chunked MLP
   (tune_kernels.mlp_chunked, csrc/mlp_chunked.cu: the hidden tensor on
   chip) at N = 197, 138, 97, 68 (and, untimed, at the edges of their
   tiles: the joint attention at B=4, N=256 and B=5, N=13, the chunked
   MLP at B=3, N=197 and B=1, N=5, rows no multiple of its 128 a block),
   and the residual-fused training
   attention branch (proto_residual_fuse.attend_block_res: the proj
   GEMM's scaled variant, the row_scale kernel and the LayerNorm
   backward's residual variant) forward and backward at N = 197, 138, 97
   with a drop-path scale that drops some images: each against its plain
   version within 2e-2 of max|plain| (and each output's branch, out - x,
   from x scaled by 2^-4, within 2e-2 of its own max; at the residual's
   full size out's rounding, an ulp of |x|, hides the branch; the joint
   kernel's launch alone, its
   merged heads from LN1's rows, likewise; every gradient for random
   cotangents of both outputs), a second launch bit-equal (and the
   chunked MLP's chunks=2 bit-equal to its default), each time by CUDA
   events (one of ten back-to-back calls; the backward as its chain of
   launches, without autograd's host work) beside its bound, its plain
   version and the port's current route (fused_block_attention,
   fused_mlp_residual, attend_branch_train with x + drop_path(branch) in
   PyTorch), the joint attention also beside SDPA's attention alone on
   the same q, k and v. Then each tool's main() once with few calls a
   timed run (tune_kernels, proto_residual_fuse, profile_kernels,
   profile_train_kernels, profile_keep025), their counts set to 0 just
   before and read just after: the four kernels' launches, each once a
   call of its wrapper.
10. the last kernel tools (tokenreduction_tpu_torch/tools/), on no path of
   the models, bf16 at B=256 and DeiT-S width: the attention-core
   arrangements (proto_attn.proto_attn, csrc/proto_attn.cu: loop, avpair,
   stacked, on wgmma and TMA) at N = 197, 138, 97, 68 and, untimed, at
   (B, N) = (4, 256) and (5, 13) against proto_attn_ref (out; the
   branch out - x with x scaled by 2^-4 and the weights by 2^4 and 2^6,
   since without a LayerNorm the branch shrinks with x; the merged heads
   of the kernel's launch alone), and the recomputing branch backward
   (proto_attn_bwd.proto_attn_bwd, csrc/proto_attn_bwd.cu: loop, pack2) at
   N = 197, 138, 97, 50 and, untimed, at (4, 256), (5, 13) and (4, 65)
   (the last query and key tiles partial) with seeded cotangents and
   drow0 against
   proto_attn_bwd_ref (dx, dwqkv, dwproj; merged and dqkv of the launch
   alone), each within 2e-2 of its own max|plain|, a second launch
   bit-equal, the arrangements' differences printed, each time one of ten
   back-to-back calls between two events beside the bound, the plain
   version and the port's current route (the qkv GEMM, the sm_90a
   attention and the proj GEMM; #9's forward and backward), each check's
   counts set to 0 just before and read just after. proto_gelu's variants
   of #4's route at N = 197 (erf, identity, tanh, no-LN: the bf16 GEMM's
   epilogue activations, tanh its own variant of the kernel) against
   mlp_variant_ref: out and the branch within 2e-2 of their own
   max|plain|, a second call bit-equal, the bf16 GEMM's launches counted,
   and the fc1 launch alone with fp32 out within 1e-4 of its own max and
   ten times nearer its own GELU form than the other. Then each new tool's
   main() once with few calls a timed run (proto_attn, proto_attn_bwd,
   proto_gelu, proto_opt, profile_eval, profile_train, bench_input,
   accuracy_gate on a seeded DeiT-S .pth that the phase writes,
   tpu_parity with a 32-step mini-train), the two kernels' counts set to
   0 before and read after; the phase prints its seconds.
11. parallel: data parallel and FSDP (tokenreduction_tpu_torch/parallel/)
   in child processes (``python3 chip_smoke.py --phase11 JOB DIR CARD``,
   started as torchrun starts ranks), so that no process group outlives
   the phase in this process. DeiT-S topk@0.7 in amp from one seeded
   init, phase 5's recipe, three steps of b256: on one rank over NCCL the
   plain step, DDP and FSDP, whose losses, gradient norms, masters, EMA
   and moments must be bit-equal to the plain step's, each with its ms a
   step (host clock around synchronised steps) and peak memory; the train
   CLI with ``--fsdp --world_size 1`` in that process group (one epoch of
   512 synthetic images at b256), its checkpoint read back by validate.
   Then two ranks on the one card over gloo: a probe of each collective
   of the path on CUDA tensors, printed (point to point, mixup's partner
   exchange, is not in this recipe); when the step's four work, DDP and
   FSDP at 2 x b128 against the one-rank b256 step (losses within a
   bf16 ulp, 2^-7, and gradient norms within 2e-2 relative, every param
   within AdamW's update range and all but 1% within 1e-3 of its leaf's
   max). Each run's counts set to 0 just before and read just after, the
   training kernels' per step as phase 5 counts them.
12. wide: the attention above 256 tokens (csrc/attention_wide_sm90.cu,
   bf16; csrc/attention_wide_tf32.cu and attention_wide_tf32_bwd.cu,
   fp32), also callable alone (``python3 -c 'import chip_smoke;
   chip_smoke.phase_wide()'``, which builds the kernels and prints their
   ptxas lines and shared memory first; phase 1 prints their shared
   memory at N = 290, 577, 1025 and 2048). Each wide launch alone against
   its plain version (computed in chunks of 16 images) at N = 257, 290,
   577 and 1025, 6 heads (DeiT-S) and at 577 and 1025 with 12 (DeiT-B):
   bf16 B=256, fp32 B=32; the eval forward with row0 and colsum, with
   row0 alone (the one-walk square forward), with ToMe's bias, with a
   mask that has fully masked rows, in bf16 the normalised-P forward with
   row0 and colsum and with its statistics, the backward of the branch
   (row0 cotangent), of ToMe's core (bias, both cotangents, dbias) and of
   a masked core; in fp32 the backward of the branch (row0 cotangent) and
   of the core with every option (bias, mask, both cotangents, dbias),
   and the branch's at B=256, N=577 for the kernels' record; the
   rectangular variant at
   M x N = 405 x 577, 300 x 577, 13 x 290 (and 405 x 577 at 12 heads),
   its padded slots equal to CLS and its dead slot uniform. Each output
   within 1e-2 (bf16) or 1e-4 (fp32) of its own max, a second launch
   bit-equal, its ms per launch (CUDA events) beside its bound, SDPA's
   ms (the output alone) and at B=256, N=577, 6 heads the plain
   version's. Then #2 with the bias and keys and with the idx prologue
   577 -> 404 and #8 at 405 x 577 as whole blocks (2e-2 bf16 B=256,
   1e-4 fp32 B=32). Then the 384-px path (N = 577): bf16 b256 eval of
   dense, topk@0.7 (577 -> 404 -> 283 -> 198, crossing to the
   single-pass kernels), ToMe@0.7, ATS@0.7, heuristic, EViT@0.7 and
   DyViT@0.7 with their launches and no plain attention, img/s beside the
   attention halves as eager library calls (dense, topk@0.7) and the
   plain attention above 256 (PR 22's gate, dense); fp32 eval of dense,
   topk@0.7 and ATS@0.7 at B=4 against the CPU (logits 1e-4, decisions
   under phase 3's rule); the amp topk@0.7 step at b256 (ms/step, peak
   memory, launches) beside PR 22's gate, and one step's loss and
   gradients of dense and topk@0.7 at B=2 against the CPU's fp32; the
   fp32 topk@0.7 step at b256 on the kernels (no plain attention) beside
   the single-width gate, and one fp32 step's loss and gradients of
   dense and topk@0.7 at B=2 against the CPU's (1e-4); in both, topk's
   CPU step gathers the card's kept tokens;
   ``validate --input-size 384`` (fp32 and amp) over 128 synthetic images
   from a seeded 384-px DeiT-S checkpoint. Each path's counts set to 0
   just before and read just after; every wide kernel must launch there.

Phases 4, 5, 6, 7, 8, 11 and 12 are the main path's runs: each counterpart's
launch count, and those of the bf16 GEMM's two launchers (gemm,
gemm_wgrad), of the fp32 tensor-core GEMM and attention (gemm_tf32,
attention_tf32: the DyViT teacher's 4 and 1 a block in phase 5, none
in phase 4's bf16 run; the
fp32 backward's attention_bwd_tf32, gemm_bwd_tf32 and gemm_wgrad_tf32
from phase 5's fp32 train step, the fp32 rectangular attention from
phase 4's ATS@0.7 fp32 forwards, each read from its own path's run), of
the sm_90a attention's three (short_attention, short_attention_bwd,
rect_attention: once in each of ATS's sampling blocks), of the LayerNorm
backward and of the partial sums (once each in each training branch's
backward), of head_mean_keys (once in each of ToMe@0.7's three merging
blocks), of layer_norm and of the wide kernels (phase 12), is set to 0
just before and read just after (phase 6's, 7's, 8's, 11's and 12's
launches add to phases 4 and 5's in the kernels' record). fused_attention,
fused_attention_qkv and fused_rect_attention run on no model's path
(the first is the training core's forward, counted there; the last is
fused_rect_block's attention stage): they must launch 0 times there, and
their records say so.

No failure is caught: any phase that fails ends the script with a
traceback and a non-zero exit code, before the result lines. Each phase
ends with its seconds since the start. The last two lines are the
kernels' JSON record and the result JSON.
"""

from __future__ import annotations

import argparse
import collections
import copy
import functools
import gc
import itertools
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import time
import warnings

import torch
import torch.nn.functional as F

import tokenreduction_tpu_torch
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core import layers
from tokenreduction_tpu_torch.core.config import SIZE_PRESETS, ViTConfig
from tokenreduction_tpu_torch.ops import (
    _build,
    dyvit as dyvit_ops,
    fused_block_train,
    fused_mlp_train,
)
from tokenreduction_tpu_torch.ops.flash_attention import (
    SHORT_ATTENTION_MAX_N,
    attention_ref,
    fused_attention,
    fused_attention_qkv,
    fused_attention_qkv_ref,
    fused_attention_ref,
    fused_block_attention,
    fused_block_attention_ref,
    fused_rect_attention,
    fused_rect_attention_ref,
    fused_rect_block,
    fused_rect_block_ref,
    head_mean_keys_ref,
    layer_norm_bwd_ref,
    layer_norm_f32,
    layer_norm_stats,
    MASK_VALUE,
    linear_f32,
    ln_qkv,
    merged_heads,
    packed_heads,
    rect_attention_ref,
)
from tokenreduction_tpu_torch.ops.flash_attention_train import (
    attention_core_train,
    attention_core_train_bwd_ref,
)
from tokenreduction_tpu_torch.ops.fused_block_train import (
    attend_branch_train,
    attend_branch_train_bwd_ref,
    attend_branch_train_ref,
    attention_bwd_ref,
    attention_train_ref,
)
from tokenreduction_tpu_torch.ops.fused_full_block import (
    fused_full_block,
    fused_full_block_ref,
)
from tokenreduction_tpu_torch.ops.fused_mlp import (
    fused_mlp_gather_residual,
    fused_mlp_gather_residual_ref,
    fused_mlp_residual,
    fused_mlp_residual_ref,
)
from tokenreduction_tpu_torch.ops.fused_mlp_train import (
    gelu_grad,
    mlp_branch,
    mlp_branch_bwd_ref,
    mlp_branch_ref,
)
from tokenreduction_tpu_torch.core.config import reduction_schedule
from tokenreduction_tpu_torch.ops.gather import complement_idx, take_tokens
from tokenreduction_tpu_torch.reduction import ats as ats_model
from tokenreduction_tpu_torch.reduction import cluster as cluster_model
from tokenreduction_tpu_torch.reduction import tome as tome_model
from tokenreduction_tpu_torch.reduction.heuristic import heuristic_masks
from tokenreduction_tpu_torch.train import losses
from tokenreduction_tpu_torch.train import loop as train_loop
from tokenreduction_tpu_torch.train.optim import OptimConfig, create_optimizer
from tokenreduction_tpu_torch.train.step import (
    StepConfig,
    init_train_state,
    loss_and_grads,
    make_train_step,
)
from tokenreduction_tpu_torch.tools import (
    _measure,
    accuracy_gate,
    bench_input,
    profile_eval,
    profile_keep025,
    profile_kernels,
    profile_train,
    profile_train_kernels,
    proto_attn,
    proto_attn_bwd,
    proto_gelu,
    proto_opt,
    proto_residual_fuse,
    tpu_parity,
    tune_kernels,
)

DEVICE = "cuda"
D, HEADS, H4 = 384, 6, 1536  # DeiT-S
SCALE = (D // HEADS) ** -0.5
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of max|plain|
BATCH = {torch.float32: 32, torch.bfloat16: 256}
# a bf16 launch alone, of the tensor's own max|plain|: bf16 outputs, and
# fp32 outputs of bf16 operands
LAUNCH_BOUND = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# of max|CPU|; in bf16 for dense only (no selection)
MODEL_BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MODEL_BATCH = {torch.float32: 8, torch.bfloat16: 32}
MODEL_TOP1 = {torch.float32: 1.0, torch.bfloat16: 0.9}
KEPT_SET = {torch.float32: 1.0, torch.bfloat16: 0.9}  # share of kept ids
DYVIT_WIDTHS = (138, 97, 68)
# share of ToMe's Assignment_Maps entries equal to the CPU's (bf16: bound
# set from the measured 0.928)
ASSIGN_SAME = {torch.float32: 1.0, torch.bfloat16: 0.9}
# share of ATS's Kept_Tokens equal to the CPU's (bf16: bound set from the
# measured 0.9918 with these random weights; trained weights flip more,
# tools/tpu_parity.py:456-459, and are not checked here)
ATS_SAME = {torch.float32: 1.0, torch.bfloat16: 0.95}
# one train step on the card against the CPU, of each tensor's max|CPU|:
# fp32 the loss and every gradient leaf, with the same kept ids. bf16 amp
# (bounds set from measured runs: loss 4.5e-3, dense gradients 1.6e-2):
# the loss, dense's gradient leaves, and topk's share of kept ids in the
# CPU's kept set; topk's bf16 gradients, taken over other tokens where a
# near-tied score flips, are reported only
TRAIN_BOUND = {torch.float32: dict(loss=1e-4, grads=1e-4, kept_set=1.0),
               torch.bfloat16: dict(loss=2e-2, grads=5e-2, kept_set=0.9)}
# models whose bf16 amp gradients are held against the CPU's fp32 ones:
# heuristic's masked blocks run nn.LayerNorm under amp, and on the CPU its
# bf16 backward puts the LN biases' gradients far off the fp32 ones (the
# report prints how far; the card's bf16 ones stay close to fp32)
FP32_GRAD_REF = ("heuristic",)
EPS = 1e-6
# H100 SXM peak rates (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
# bound the bf16 kernels; TF32 tensor cores bound an fp32-accurate product
# (3xTF32: three TF32 products each, the least time the card needs for one:
# every fp32 GEMM and attention run so); fp32 outside the tensor cores,
# the rate of a true fp32 product on the CUDA cores, is printed beside it
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_FP32_FLOPS = 67e12
EVAL_WRAPPERS = {
    "fused_full_block": fused_full_block,
    "fused_block_attention": fused_block_attention,
    "fused_mlp_gather_residual": fused_mlp_gather_residual,
    "fused_mlp_residual": fused_mlp_residual,
    "fused_rect_block": fused_rect_block,
}
TRAIN_WRAPPERS = {
    "attend_branch_train": attend_branch_train,
    "mlp_branch": mlp_branch,
    "attention_core_train": attention_core_train,
}
# counterparts that no model of the main path calls: the attention core
# alone (the training core's forward, counted there), its packed-qkv form
# and the rectangular attention (fused_rect_block's attention stage)
OFF_PATH_WRAPPERS = {
    "fused_attention": fused_attention,
    "fused_attention_qkv": fused_attention_qkv,
    "fused_rect_attention": fused_rect_attention,
}
WRAPPERS = {**EVAL_WRAPPERS, **TRAIN_WRAPPERS, **OFF_PATH_WRAPPERS}
REPLACES = {
    "fused_full_block": "tokenreduction_tpu/ops/fused_full_block.py:118",
    "fused_block_attention": "tokenreduction_tpu/ops/flash_attention.py:660",
    "fused_mlp_gather_residual": "tokenreduction_tpu/ops/fused_mlp.py:192",
    "fused_mlp_residual": "tokenreduction_tpu/ops/fused_mlp.py:137",
    "attend_branch_train": "tokenreduction_tpu/ops/fused_block_train.py:344",
    "mlp_branch": "tokenreduction_tpu/ops/fused_mlp_train.py:257",
    "attention_core_train":
        "tokenreduction_tpu/ops/flash_attention_train.py:172",
    "fused_attention": "tokenreduction_tpu/ops/flash_attention.py:183",
    "fused_attention_qkv": "tokenreduction_tpu/ops/flash_attention.py:313",
    "fused_rect_attention": "tokenreduction_tpu/ops/flash_attention.py:817",
    "fused_rect_block": "tokenreduction_tpu/ops/flash_attention.py:925",
}
# the kernel wrapper of each counterpart, and the CUDA sources it launches
# (the first is the record's "source")
WRAPPER_SOURCES = {
    name: f"tokenreduction_tpu_torch/ops/{module}.py"
    for name, module in (("fused_full_block", "fused_full_block"),
                         ("fused_block_attention", "flash_attention"),
                         ("fused_mlp_gather_residual", "fused_mlp"),
                         ("fused_mlp_residual", "fused_mlp"),
                         ("attend_branch_train", "fused_block_train"),
                         ("mlp_branch", "fused_mlp_train"),
                         ("attention_core_train", "flash_attention_train"),
                         ("fused_attention", "flash_attention"),
                         ("fused_attention_qkv", "flash_attention"),
                         ("fused_rect_attention", "flash_attention"),
                         ("fused_rect_block", "flash_attention"))}
LN_GEMM = "tokenreduction_tpu_torch/csrc/ln_gemm.cu"
GEMM_SOURCE = "tokenreduction_tpu_torch/csrc/gemm_sm90.cu"
GEMM_TF32_SOURCE = "tokenreduction_tpu_torch/csrc/gemm_tf32_sm90.cu"
GEMM_TF32_BWD_SOURCE = "tokenreduction_tpu_torch/csrc/gemm_tf32_bwd_sm90.cu"
# the bf16 GEMM computes the MXU products of every counterpart but the
# attention core; its record names mlp_branch's, the most launched
GEMM_REPLACES = {"gemm": "tokenreduction_tpu/ops/fused_mlp_train.py:162",
                 "gemm_wgrad": "tokenreduction_tpu/ops/fused_mlp_train.py:218"}
ATTENTION = "tokenreduction_tpu_torch/csrc/short_attention.cu"
ATTENTION_BWD = "tokenreduction_tpu_torch/csrc/short_attention_bwd.cu"
ATTENTION_SM90 = "tokenreduction_tpu_torch/csrc/attention_sm90.cu"
# the sm_90a attention's forward and backward: their records name the
# attention core's TPU kernels; its rectangular forward names
# fused_rect_attention's
ATTENTION_REPLACES = {
    "short_attention": "tokenreduction_tpu/ops/flash_attention.py:183",
    "short_attention_bwd":
        "tokenreduction_tpu/ops/flash_attention_train.py:145",
    "rect_attention": "tokenreduction_tpu/ops/flash_attention.py:817"}
# the LayerNorm backward of the training branches: its record names
# mlp_branch's backward, the most launched
LN_BWD_REPLACES = "tokenreduction_tpu/ops/fused_mlp_train.py:218"
# the LayerNorm forward of every counterpart: its record names the full
# block's TPU kernel, the most launched; the fixed-order partial sums, the
# training backward kernels' VMEM accumulators: mlp_branch's backward;
# the head-mean keys, the ksum by-product of fused_block_attention's
LN_REPLACES = "tokenreduction_tpu/ops/fused_full_block.py:118"
SUMS_REPLACES = "tokenreduction_tpu/ops/fused_mlp_train.py:218"
KEYS_REPLACES = "tokenreduction_tpu/ops/flash_attention.py:660"
# (bf16 first; then the fp32 route's: csrc/short_attention.cu's attention,
# short_attention_bwd.cu's backward and the fp32 GEMMs)
CUDA_SOURCES = {
    "fused_full_block": [LN_GEMM, ATTENTION_SM90, GEMM_SOURCE, ATTENTION,
                         GEMM_TF32_SOURCE],
    "fused_block_attention": [ATTENTION_SM90, ATTENTION, LN_GEMM,
                              GEMM_SOURCE, GEMM_TF32_SOURCE],
    "fused_mlp_gather_residual": [LN_GEMM, GEMM_SOURCE, GEMM_TF32_SOURCE],
    "fused_mlp_residual": [LN_GEMM, GEMM_SOURCE, GEMM_TF32_SOURCE],
    "attend_branch_train": [ATTENTION_SM90, LN_GEMM, GEMM_SOURCE, ATTENTION,
                            ATTENTION_BWD, GEMM_TF32_SOURCE,
                            GEMM_TF32_BWD_SOURCE],
    "mlp_branch": [LN_GEMM, GEMM_SOURCE, GEMM_TF32_SOURCE,
                   GEMM_TF32_BWD_SOURCE],
    "attention_core_train": [ATTENTION_SM90, ATTENTION, ATTENTION_BWD],
    "fused_attention": [ATTENTION_SM90, ATTENTION],
    "fused_attention_qkv": [ATTENTION_SM90, ATTENTION],
    "fused_rect_attention": [ATTENTION_SM90, ATTENTION],
    "fused_rect_block": [ATTENTION_SM90, LN_GEMM, GEMM_SOURCE, ATTENTION,
                         GEMM_TF32_SOURCE],
}
FULL_BLOCK_N = (197, 138, 97, 68, 50, 13, 4)
BLOCK_ATTN_N = (197, 138, 97, 50, 13)
MLP_GATHER_NK = ((197, 138), (138, 97), (97, 68), (197, 50), (50, 13),
                 (13, 4))
# the widths of topk@0.7's training halves (and dense's 197), and of
# ToMe@0.7's stages (eval and training)
TRAIN_N = (197, 138, 97, 68)
TOME_N = TRAIN_N
# ATS: the widths of the masked blocks at keep 0.7 and 0.25, and the
# (kept rows M, keys N) of their sampling blocks
ATS_N = (197, 138, 97, 68, 50, 13, 4)
RECT_MN = ((138, 197), (97, 138), (68, 97), (50, 197), (13, 50), (4, 13))
# and a pair with more kept rows than keys, which no model makes, for the
# rectangular attention's checks alone
RECT_WIDE_MN = (80, 50)
# DyViT@0.7's reduction blocks: (N -> K) of the idx prologue
DYVIT_NK = ((197, 138), (138, 97), (97, 68))
# EViT@0.7's gathered MLP halves: (N + 1 -> K), the N tokens and the fused
# token appended as row N; CLS, K - 2 kept patches and the fused row
EVIT_NK = ((198, 139), (140, 98), (99, 69))
# heuristic's masked blocks whose masks phase 2 drives: the first (184
# patches valid) and the last active one (12)
HEURISTIC_BLOCKS = (3, 9)
GRAD_NAMES = {
    "attend_branch_train": ("branch", "row0", "dx", "d ln1 scale",
                            "d ln1 bias", "d wqkv", "d bqkv", "d wproj",
                            "d bproj"),
    "mlp_branch": ("branch", "dx", "d ln2 scale", "d ln2 bias", "d w1",
                   "d b1", "d w2", "d b2"),
    "attention_core_train": ("out", "row0", "colsum", "dq", "dk", "dv",
                             "dbias"),
}
MODELS = {
    "dense": ("deit_small_patch16_224_local", {}),
    "topk@0.7": ("topk_small_patch16_224",
                 dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,))),
    "topk@0.25": ("topk_small_patch16_224",
                  dict(reduction_loc=(3, 6, 9), keep_rate=(0.25,))),
    "tome@0.7": ("tome_small_patch16_224",
                 dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,))),
    "ats@0.7": ("ats_small_patch16_224",
                dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,))),
    "heuristic": ("heuristic_small_patch16_224",
                  dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,))),
    "dyvit@0.7": ("dyvit_small_patch16_224",
                  dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,))),
    **{f"{m}@0.7": (f"{m}_small_patch16_224",
                    dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,)))
       for m in ("evit", "kmedoids", "dpcknn", "sinkhorn", "patchmerger",
                 "sit")},
}
TRAIN_MODELS = ("dense", "topk@0.7", "tome@0.7", "heuristic")
# trained in phase 5 and held against the CPU in fp32 only (phase 3)
CLUSTER_TRAIN = ("evit@0.7", "kmedoids@0.7")
# the distilled DeiT-S's tokens: CLS, the dist token and 196 patches
DISTILLED_N = 198
# the teachers, fp32 on the card in their own parameters
TEACHERS = {"dyvit teacher": "dyvit_small_patch16_224_teacher",
            "regnety_160": "regnety_160"}
# the train loop's arguments (train/loop.py::build_loss_fn), the JAX CLI's
# defaults: label smoothing 0.1, DyViT's weights, DeiT's alpha and tau
LOOP_ARGS = dict(smoothing=0.1, bce_loss=False, ratio_weight=2.0,
                 cls_distill_weight=0.5, token_distill_weight=0.5,
                 cls_weight=1.0, mse_token=False, dyvit_distill=False,
                 distillation_type="none", distillation_alpha=0.5,
                 distillation_tau=1.0, train_mode=True)
# DyViT's training and the distillation cells: (student name, its
# kwargs), the teacher (TEACHERS) or None, the loop's arguments
DISTILL_MODELS = {
    "dyvit@0.7": (MODELS["dyvit@0.7"], None, {}),
    "dyvit@0.7 distill": (
        ("dyvit_small_patch16_224", dict(**MODELS["dyvit@0.7"][1],
                                         dyvit_distillation=True)),
        "dyvit teacher", dict(dyvit_distill=True)),
    **{f"deit-s distilled {kind}": (
        ("deit_small_patch16_224_local", dict(distilled=True)),
        "regnety_160", dict(distillation_type=kind))
       for kind in ("soft", "hard")},
}
# trained in phase 5 (and checked in phase 3 with the others)
DISTILL_TRAIN = ("dyvit@0.7 distill", "deit-s distilled hard")
# bf16 amp B=32: the share of DyViT's Gumbel decisions equal to the CPU's
# (the CPU model on the card's uniforms; bound set from the measured
# 0.9996)
DYVIT_BF16_SAME = 0.99
NONE = dict.fromkeys(WRAPPERS, 0)
# launches of one forward: 12 score-less blocks (dense); 9 score-less
# blocks and 3 reduction blocks (topk at loc 3 6 9); 12 attention and 12
# MLP halves (ToMe); 9 masked attention halves, 3 sampling blocks and 12
# MLP halves (ATS); 3 full blocks before the first mask, then 9 masked
# attention and 9 MLP halves (heuristic); 9 full blocks and 3 reduction
# blocks, each an idx attention half and an MLP half (DyViT)
PER_FORWARD = {
    "dense": {**NONE, "fused_full_block": 12},
    "topk@0.7": {**NONE, "fused_full_block": 9,
                 "fused_block_attention": 3, "fused_mlp_gather_residual": 3},
    "tome@0.7": {**NONE, "fused_block_attention": 12,
                 "fused_mlp_residual": 12},
    "ats@0.7": {**NONE, "fused_block_attention": 9, "fused_rect_block": 3,
                "fused_mlp_residual": 12},
    "heuristic": {**NONE, "fused_full_block": 3, "fused_block_attention": 9,
                  "fused_mlp_residual": 9},
    "dyvit@0.7": {**NONE, "fused_full_block": 9, "fused_block_attention": 3,
                  "fused_mlp_residual": 3},
    # EViT: as topk, its gathered MLP halves over the N + 1 rows;
    # k-medoids: the blocks before each reduction (2, 5, 8) ask for the
    # attention mass, an attention and an MLP half each; the others run
    # their clustering between whole blocks
    "evit@0.7": {**NONE, "fused_full_block": 9, "fused_block_attention": 3,
                 "fused_mlp_gather_residual": 3},
    "kmedoids@0.7": {**NONE, "fused_full_block": 9,
                     "fused_block_attention": 3, "fused_mlp_residual": 3},
    **{f"{m}@0.7": {**NONE, "fused_full_block": 12}
       for m in ("dpcknn", "sinkhorn", "patchmerger", "sit")},
}
PER_FORWARD["topk@0.25"] = PER_FORWARD["topk@0.7"]
# launches of one train step, a forward and a backward each: every MLP
# half's mlp_branch; every attention half's attend_branch_train, except
# ToMe's after its first merge (blocks 4-11, with the size bias) and
# heuristic's masked ones (blocks 3-11), which take the attention core
NO_TRAIN = dict.fromkeys(TRAIN_WRAPPERS, 0)
PER_TRAIN_STEP_BWD = {
    "dense": {**NO_TRAIN, "attend_branch_train": 12, "mlp_branch": 12},
    "tome@0.7": {**NO_TRAIN, "attend_branch_train": 4, "mlp_branch": 12,
                 "attention_core_train": 8},
    "heuristic": {**NO_TRAIN, "attend_branch_train": 3, "mlp_branch": 12,
                  "attention_core_train": 9},
    # k-medoids: the attention core in its three colsum blocks
    "kmedoids@0.7": {**NO_TRAIN, "attend_branch_train": 9, "mlp_branch": 12,
                     "attention_core_train": 3},
}
for _label in ("topk@0.7", "evit@0.7", "sinkhorn@0.7",
               "deit-s distilled soft", "deit-s distilled hard"):
    PER_TRAIN_STEP_BWD[_label] = PER_TRAIN_STEP_BWD["dense"]
# DyViT in training: every attention half under the policy (plain
# PyTorch, as XLA in JAX), every MLP half mlp_branch
for _label in ("dyvit@0.7", "dyvit@0.7 distill"):
    PER_TRAIN_STEP_BWD[_label] = {**NO_TRAIN, "mlp_branch": 12}
PER_TRAIN_STEP = {label: {**NONE, **{k: 2 * n for k, n in bwd.items()}}
                  for label, bwd in PER_TRAIN_STEP_BWD.items()}
# DyViT's dense teacher: 12 fp32 full blocks a step (the RegNet teacher's
# convolutions are cuDNN's)
PER_TRAIN_STEP["dyvit@0.7 distill"]["fused_full_block"] = 12
SERVE_BATCHES, SERVE_B = 5, 256
# phase 4's forward-only img/s by (model, "bf16" or "fp32"), printed beside
# phase 6's end-to-end eval
FORWARD_IPS = {}
TRAIN_STEPS, TRAIN_B = 8, 256
# phase 5's train img/s by (model, "amp" or "fp32"), printed beside phase
# 7's train CLI
TRAIN_IPS = {}
# phase 5's counted train cells
TRAIN_CELLS = TRAIN_MODELS + CLUSTER_TRAIN + DISTILL_TRAIN


def require(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


# the bf16 GEMM's launchers (csrc/gemm_sm90.cu), counted apart: every
# counterpart but the attention core launches them
GEMMS = {"gemm": _build.gemm, "gemm_wgrad": _build.gemm_wgrad}
# the sm_90a attention's launchers (csrc/attention_sm90.cu), counted apart:
# every attention counterpart launches them in bf16
ATTENTIONS = {"short_attention": _build.short_attention_heads,
              "short_attention_bwd": _build.short_attention_bwd_heads}
# every counted launcher: (function, its count's attribute). Beside the
# above, the rectangular forward of csrc/attention_sm90.cu (ATS's sampling
# blocks), the fp32 forward GEMM (csrc/gemm_tf32_sm90.cu) and the fp32
# attention (csrc/short_attention.cu: the square and the rectangular
# forward of short_attention_tf32_kernel; csrc/short_attention_bwd.cu: the
# backward) on the tensor cores in 3xTF32, the fp32
# backward's GEMM layouts (csrc/gemm_tf32_bwd_sm90.cu: dY . W and the
# weight gradient) on them too, the
# LayerNorm forward and backward and sum_partials (csrc/ln_gemm.cu) and
# head_mean_keys (csrc/short_attention.cu)
LAUNCHERS = {
    **{name: (f, "launches") for name, f in (*GEMMS.items(),
                                             *ATTENTIONS.items())},
    "rect_attention": (_build.short_attention_heads, "rect_launches"),
    "gemm_tf32": (_build.gemm, "tf32_launches"),
    "attention_tf32": (_build.short_attention_heads, "tf32_launches"),
    "rect_attention_tf32": (_build.short_attention_heads,
                            "tf32_rect_launches"),
    "attention_bwd_tf32": (_build.short_attention_bwd_heads,
                           "tf32_launches"),
    "gemm_bwd_tf32": (_build.gemm, "tf32_bwd_launches"),
    "gemm_wgrad_tf32": (_build.gemm_wgrad, "tf32_launches"),
    **{name: (getattr(_build, name), "launches")
       for name in ("layer_norm_bwd", "layer_norm", "head_mean_keys")},
    "sum_partials": (_build.sum_partials_many, "launches"),
    # the wide kernels above 256 tokens (csrc/attention_wide_sm90.cu, bf16;
    # csrc/attention_wide_tf32.cu, fp32; phase 12)
    "attention_wide": (_build.short_attention_heads, "wide_launches"),
    "rect_attention_wide": (_build.short_attention_heads,
                            "wide_rect_launches"),
    "attention_wide_bwd": (_build.short_attention_bwd_heads,
                           "wide_launches"),
    "attention_wide_tf32": (_build.short_attention_heads,
                            "wide_tf32_launches"),
    "rect_attention_wide_tf32": (_build.short_attention_heads,
                                 "wide_tf32_rect_launches"),
    # the fp32 backward above 256 tokens (csrc/attention_wide_tf32_bwd.cu)
    "attention_wide_bwd_tf32": (_build.short_attention_bwd_heads,
                                "wide_tf32_launches")}


# the fp32 launchers, none of which a bf16 run launches
FP32_LAUNCHERS = ("gemm_tf32", "attention_tf32", "rect_attention_tf32",
                  "attention_bwd_tf32", "gemm_bwd_tf32", "gemm_wgrad_tf32")


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0
    for f, attr in LAUNCHERS.values():
        setattr(f, attr, 0)
    for w in TRAIN_WRAPPERS.values():
        w.backward_launches = 0


def launcher_counts() -> dict:
    return {name: getattr(f, attr) for name, (f, attr) in LAUNCHERS.items()}


def counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def backward_counts() -> dict:
    return {name: w.backward_launches for name, w in TRAIN_WRAPPERS.items()}


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() over `runs` runs, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(name: str, B: int, N: int, K: int | None = None,
          masked: bool = False, dtype=torch.bfloat16, fma: bool = False):
    """(least ms, "bytes" or "operations") of a bf16 counterpart at these
    shapes (K: the gathered MLP's rows, or the rectangular attention's
    kept rows): each input read once and each output written once over
    the H100's memory rate, against the products' operations (forward, and
    for the training counterparts also backward, with no recompute) over
    its bf16 tensor-core rate. Of a packed qkv or an x that is read through
    kept-row ids, only the kept rows count. ``masked``: a bool validity
    mask [B, N] read too (the rectangular counterparts always read one).
    fused_block_attention with K: the idx prologue, the block over the K
    kept rows (of x only they are read) and their int64 ids. fp32: 4-byte
    elements and 3xTF32 on the tensor cores (three TF32 products for each
    product), or with ``fma`` the fp32 rate outside the tensor cores (a
    true fp32 product on the CUDA cores)."""
    ids = 0
    if name == "fused_block_attention" and K is not None:
        N, ids = K, 8 * B * K
    E, M = (4 if dtype == torch.float32 else 2), B * N
    attn_w = 4 * D * D + 6 * D  # wqkv, bqkv, wproj, bproj, LN scale, bias
    mlp_w = 8 * D * D + H4 + 3 * D
    by_products = 4 * B * HEADS * N  # one fp32 [B, H, N]
    if name == "fused_full_block":
        flops = 24 * M * D * D + 4 * B * N * N * D
        nbytes = E * (2 * M * D + attn_w + mlp_w)
    elif name == "fused_block_attention":
        flops = 8 * M * D * D + 4 * B * N * N * D
        nbytes = E * (2 * M * D + attn_w) + 2 * by_products
    elif name == "fused_mlp_gather_residual":  # the K gathered rows
        flops = 16 * B * K * D * D
        nbytes = E * (2 * B * K * D + mlp_w) + 8 * B * K
    elif name == "fused_mlp_residual":
        flops = 16 * M * D * D
        nbytes = E * (2 * M * D + mlp_w)
    elif name == "fused_attention":  # q, k, v, bias in; out, row0, colsum
        flops = 4 * B * N * N * D
        nbytes = E * 4 * M * D + 2 * by_products + 4 * B * N
    elif name == "fused_attention_qkv":  # qkv in; out, row0, colsum
        flops = 4 * B * N * N * D
        nbytes = E * 4 * M * D + 2 * by_products
    elif name == "fused_rect_attention":  # kept q rows, k, v, the one-hot
        flops = 4 * B * K * N * D  # [B, K, N] and the mask in; [B, K, D] out
        nbytes = E * (2 * M * D + 2 * B * K * D + B * K * N) + B * N
    elif name == "fused_rect_block":  # kept q and x rows, k, v, int64 ids,
        flops = 4 * B * K * N * D + 2 * B * K * D * D  # mask, wproj, bproj
        nbytes = E * (2 * M * D + 3 * B * K * D + D * D + D) + 8 * B * K \
            + B * N
    elif name == "attend_branch_train":  # x, dy, drow0 in; out, row0, dx,
        flops = 24 * M * D * D + 12 * B * N * N * D  # and the grads out
        nbytes = E * (4 * M * D + 2 * attn_w) + 2 * by_products
    elif name == "attention_core_train":  # q, k, v, bias, dout, drow0, dcs
        flops = 12 * B * N * N * D  # in; out, row0, colsum, dq, dk, dv,
        # dbias; the masked core (heuristic's) has no bias and no dbias
        nbytes = E * 8 * M * D + 4 * by_products + (0 if masked
                                                    else 8 * B * N)
    else:  # mlp_branch
        flops = 48 * M * D * D
        nbytes = E * (4 * M * D + 2 * mlp_w)
    if masked:
        nbytes += B * N
    nbytes += ids
    if dtype == torch.bfloat16:
        t_ops = flops / PEAK_FLOPS
    else:
        t_ops = flops / PEAK_FP32_FLOPS if fma else 3 * flops / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


# ---- the eager bf16 compositions of library calls (timing yardsticks;
# the port never calls them)
def float_mask(dtype, bias=None, q_valid=None, k_valid=None):
    """SDPA's float mask [B, 1, M, N] in ``dtype``: the per-key bias and,
    with the validity of queries and keys, the dtype's lowest value on
    every pair with an invalid token (a bool mask would give NaN on a
    fully masked row)."""
    mask = None if bias is None else bias.to(dtype)[:, None, None, :]
    if k_valid is not None:
        pair = q_valid[:, None, :, None] & k_valid[:, None, None, :]
        low = torch.zeros(pair.shape, dtype=dtype, device=pair.device) \
            .masked_fill_(~pair, torch.finfo(dtype).min)
        mask = low if mask is None else mask + low
    return mask


def library_core(q, k, v, scale, bias=None, mask=None):
    """(softmax(q k^T * scale [+ bias] [pair mask]) v, the fp32 CLS row of
    the probabilities, None) over [B, H, N, hd]: no column mass. Also a
    drop-in for attention_core_train in Attention (phase 5)."""
    o = F.scaled_dot_product_attention(
        q, k, v, attn_mask=float_mask(q.dtype, bias, mask, mask), scale=scale)
    logits = (q[:, :, :1] @ k.transpose(-1, -2)).float() * scale
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], -3e38)
    return o, torch.softmax(logits, -1)[:, :, 0], None


def library_attention(x, ls, lb, wqkv, bqkv, wproj, bproj, num_heads=HEADS,
                      scale=SCALE, eps=EPS, bias=None, want_keys=False,
                      mask=None):
    """(proj(attn(qkv(LN x))), the fp32 CLS row of the probabilities) and,
    with want_keys, the head-mean keys; also a drop-in for
    attend_branch_train in Block (phase 5)."""
    B, N, Dx = x.shape
    ln = F.layer_norm(x, (Dx,), ls, lb, eps)
    q, k, v = F.linear(ln, wqkv, bqkv).view(B, N, 3, num_heads, -1) \
        .permute(2, 0, 3, 1, 4)
    o, row0, _ = library_core(q, k, v, scale, bias, mask)
    y = F.linear(o.transpose(1, 2).reshape(B, N, Dx), wproj, bproj)
    return (y, row0, k.mean(1)) if want_keys else (y, row0)


def library_rect(qkv, idx, mask):
    """The rectangular attention as library calls: the kept query rows
    gathered, then SDPA with the pair mask as a float mask; merged heads
    [B, M, D]."""
    q, k, v = packed_heads(qkv, HEADS)
    B, M = idx.shape
    q = torch.gather(q, 2, idx[:, None, :, None].expand(B, HEADS, M,
                                                          q.shape[-1]))
    attn_mask = float_mask(qkv.dtype, None, torch.gather(mask, 1, idx), mask)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                       scale=SCALE)
    return o.transpose(1, 2).reshape(B, M, D)


def token_mask(B, N, gen):
    """A validity mask on the card: CLS valid, about a fifth of the other
    tokens off (each a fully masked query row), as after a sampling
    block's pads."""
    mask = torch.rand(B, N, generator=gen) > 0.2
    mask[:, 0] = True
    return mask.to(DEVICE)


def kept_ids(B, N, M, mask, gen):
    """ATS's kept rows [B, M] on the card: CLS, sorted sampled ids, pads
    (0, the CLS row, repeated) at the tail, and slot 1 re-sampling a dead
    token."""
    n = min(M - 1, N - 1) - 1
    ids = torch.zeros(B, M, dtype=torch.long)
    for b in range(B):
        ids[b, 1:1 + n] = (1 + torch.randperm(N - 1, generator=gen)[:n]) \
            .sort().values
        dead = torch.nonzero(~mask[b].cpu()).flatten()
        if dead.numel():
            ids[b, 1] = dead[0]
    return ids.to(DEVICE)


def library_mlp(x, ls, lb, w1, b1, w2, b2, eps=EPS):
    ln = F.layer_norm(x, (x.shape[-1],), ls, lb, eps)
    return F.linear(F.gelu(F.linear(ln, w1, b1)), w2, b2)


def log_sizes(B, N, gen, dtype):
    """A ToMe bias on the card: the log of merged-token sizes 1..4."""
    sizes = torch.randint(1, 5, (B, N), generator=gen).float()
    return torch.log(sizes).to(DEVICE, dtype)


def library_full_block(x, ls1, lb1, wqkv, bqkv, wproj, bproj, ls2, lb2, w1,
                       b1, w2, b2):
    y = x + library_attention(x, ls1, lb1, wqkv, bqkv, wproj, bproj)[0]
    return y + library_mlp(y, ls2, lb2, w1, b1, w2, b2)


def block_params(dtype, gen):
    """Seeded block weights in nn.Linear layout, on the card."""
    def r(*shape, scale=0.05, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=gen)) \
            .to(device=DEVICE, dtype=dtype)

    return dict(
        ls1=r(D, scale=0.1, shift=1.0), lb1=r(D, scale=0.1),
        wqkv=r(3 * D, D), bqkv=r(3 * D), wproj=r(D, D), bproj=r(D),
        ls2=r(D, scale=0.1, shift=1.0), lb2=r(D, scale=0.1),
        w1=r(H4, D), b1=r(H4), w2=r(D, H4), b2=r(D))


ATTN = ("ls1", "lb1", "wqkv", "bqkv", "wproj", "bproj")
MLP = ("ls2", "lb2", "w1", "b1", "w2", "b2")


def kernel_cases(dtype, gen):
    """(kernel name, shape label, kernel call, plain call, library call)
    at the main path's widths."""
    B = BATCH[dtype]
    p = block_params(dtype, gen)
    attn = [p[k] for k in ATTN]
    mlp = [p[k] for k in MLP]

    def x_of(N):
        return torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)

    for N in FULL_BLOCK_N:
        x = x_of(N)
        yield ("fused_full_block", f"B={B} N={N}",
               lambda x=x: fused_full_block(x, *attn, *mlp, HEADS, SCALE),
               lambda x=x: fused_full_block_ref(x, *attn, *mlp, HEADS, SCALE),
               lambda x=x: library_full_block(x, *attn, *mlp))
    for N in BLOCK_ATTN_N:
        x = x_of(N)
        yield ("fused_block_attention", f"B={B} N={N}",
               lambda x=x: fused_block_attention(x, *attn, HEADS, SCALE),
               lambda x=x: fused_block_attention_ref(x, *attn, HEADS, SCALE),
               lambda x=x: (x + library_attention(x, *attn)[0]))
    for N in TOME_N:
        x, bias = x_of(N), log_sizes(B, N, gen, dtype)

        def library(x=x, bias=bias):
            y, row0, keys = library_attention(x, *attn, bias=bias,
                                              want_keys=True)
            return x + y, row0, keys

        yield ("fused_block_attention", f"B={B} N={N} bias keys",
               lambda x=x, bias=bias: fused_block_attention(
                   x, *attn, HEADS, SCALE, bias=bias, want_keys=True),
               lambda x=x, bias=bias: fused_block_attention_ref(
                   x, *attn, HEADS, SCALE, bias=bias, want_keys=True),
               library)
        yield ("fused_mlp_residual", f"B={B} N={N}",
               lambda x=x: fused_mlp_residual(x, *mlp),
               lambda x=x: fused_mlp_residual_ref(x, *mlp),
               lambda x=x: x + library_mlp(x, *mlp))
        # the attention core alone (the training core's forward), over
        # views of a packed qkv
        qkv = torch.randn(B, N, 3 * D, generator=gen).to(DEVICE, dtype)
        heads = packed_heads(qkv, HEADS)
        yield ("fused_attention", f"B={B} N={N}",
               lambda h=heads, b=bias: fused_attention(*h, SCALE, bias=b),
               lambda h=heads, b=bias: fused_attention_ref(*h, SCALE, bias=b),
               lambda h=heads, b=bias: library_core(*h, SCALE, b))
    for N, K in MLP_GATHER_NK:
        x = x_of(N)
        idx = torch.stack([
            torch.cat([torch.zeros(1, dtype=torch.long),
                       1 + torch.randperm(N - 1, generator=gen)[:K - 1]])
            for _ in range(B)]).to(DEVICE)

        def library(x=x, idx=idx):
            g = take_tokens(x, idx)
            return g + library_mlp(g, *mlp)

        yield ("fused_mlp_gather_residual", f"B={B} N={N} K={K}",
               lambda x=x, idx=idx: fused_mlp_gather_residual(x, idx, *mlp),
               lambda x=x, idx=idx: fused_mlp_gather_residual_ref(x, idx,
                                                                  *mlp),
               library)
    for N, K in EVIT_NK:
        x = x_of(N)
        idx = torch.stack([
            torch.cat([torch.zeros(1, dtype=torch.long),
                       1 + torch.randperm(N - 2, generator=gen)[:K - 2],
                       torch.full((1,), N - 1)])
            for _ in range(B)]).to(DEVICE)

        def library(x=x, idx=idx):
            g = take_tokens(x, idx)
            return g + library_mlp(g, *mlp)

        yield ("fused_mlp_gather_residual", f"B={B} N={N} K={K} EViT",
               lambda x=x, idx=idx: fused_mlp_gather_residual(x, idx, *mlp),
               lambda x=x, idx=idx: fused_mlp_gather_residual_ref(x, idx,
                                                                  *mlp),
               library)
    yield from ats_cases(B, dtype, gen, attn)
    for N, K in DYVIT_NK:
        x = x_of(N)
        # DyViT's kept ids: CLS, then the patches in score order (unsorted)
        idx = torch.stack([
            torch.cat([torch.zeros(1, dtype=torch.long),
                       1 + torch.randperm(N - 1, generator=gen)[:K - 1]])
            for _ in range(B)]).to(DEVICE)

        def library(x=x, idx=idx):
            g = take_tokens(x, idx)
            return g + library_attention(g, *attn)[0]

        yield ("fused_block_attention", f"B={B} N={N} K={K} idx",
               lambda x=x, i=idx: fused_block_attention(x, *attn, HEADS,
                                                        SCALE, idx=i),
               lambda x=x, i=idx: fused_block_attention_ref(
                   take_tokens(x, i), *attn, HEADS, SCALE),
               library)
    if dtype == torch.float32:
        # the DyViT teacher's blocks: fp32 at the train batch (phase 5)
        x = torch.randn(TRAIN_B, 197, D, generator=gen).to(DEVICE, dtype)
        yield ("fused_full_block", f"B={TRAIN_B} N=197 teacher",
               lambda x=x: fused_full_block(x, *attn, *mlp, HEADS, SCALE),
               lambda x=x: fused_full_block_ref(x, *attn, *mlp, HEADS, SCALE),
               lambda x=x: library_full_block(x, *attn, *mlp))


def heuristic_block_masks() -> dict:
    """{block: validity mask [197] bool} of heuristic on DeiT-S at the
    defaults (pattern l1, min_radius 1.0, contiguous), loc 3 6 9."""
    cfg = ViTConfig(**SIZE_PRESETS["small"], method="heuristic",
                    **MODELS["heuristic"][1])
    return heuristic_masks(cfg)[1]


def batch_mask(mask, B):
    """A block's token mask [N] (numpy) as the batch's [B, N] on the card."""
    return torch.from_numpy(mask).to(DEVICE)[None].expand(B, -1).contiguous()


def ats_cases(B, dtype, gen, attn):
    """ATS's counterparts: the masked attention half and core, the
    packed-qkv attention, and the rectangular attention and block at the
    (M, N) of ATS@0.7 and @0.25, each mask with tokens off (fully masked
    query rows) and each kept-row set with pads and a dead slot."""
    wproj, bproj = attn[4], attn[5]
    for N in ATS_N:
        x = torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)
        mask = token_mask(B, N, gen)
        yield ("fused_block_attention", f"B={B} N={N} mask",
               lambda x=x, m=mask: fused_block_attention(
                   x, *attn, HEADS, SCALE, mask=m),
               lambda x=x, m=mask: fused_block_attention_ref(
                   x, *attn, HEADS, SCALE, mask=m),
               lambda x=x, m=mask: (x + library_attention(x, *attn,
                                                          mask=m)[0]))
        if N not in TRAIN_N:
            continue
        qkv = torch.randn(B, N, 3 * D, generator=gen).to(DEVICE, dtype)
        heads = packed_heads(qkv, HEADS)
        yield ("fused_attention", f"B={B} N={N} mask",
               lambda h=heads, m=mask: fused_attention(*h, SCALE, mask=m),
               lambda h=heads, m=mask: fused_attention_ref(*h, SCALE, mask=m),
               lambda h=heads, m=mask: library_core(*h, SCALE, mask=m))

        def library_qkv(h=heads, m=mask):
            o, row0, _ = library_core(*h, SCALE, mask=m)
            return o.transpose(1, 2).reshape(B, -1, D), row0

        yield ("fused_attention_qkv", f"B={B} N={N} mask",
               lambda q=qkv, m=mask: fused_attention_qkv(q, HEADS, SCALE,
                                                         mask=m),
               lambda q=qkv, m=mask: fused_attention_qkv_ref(q, HEADS, SCALE,
                                                             mask=m),
               library_qkv)
    for M, N in RECT_MN:
        qkv = torch.randn(B, N, 3 * D, generator=gen).to(DEVICE, dtype)
        x = torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)
        mask = token_mask(B, N, gen)
        idx = kept_ids(B, N, M, mask, gen)
        onehot = F.one_hot(idx, N).to(dtype)
        shape = f"B={B} N={N} M={M}"
        yield ("fused_rect_attention", shape,
               lambda q=qkv, o=onehot, m=mask: fused_rect_attention(
                   q, o, m, HEADS, SCALE),
               lambda q=qkv, o=onehot, m=mask: fused_rect_attention_ref(
                   q, o, m, HEADS, SCALE),
               lambda q=qkv, i=idx, m=mask: library_rect(q, i, m))
        yield ("fused_rect_block", shape,
               lambda q=qkv, x=x, i=idx, m=mask: fused_rect_block(
                   q, x, i, m, wproj, bproj, HEADS, SCALE),
               lambda q=qkv, x=x, i=idx, m=mask: fused_rect_block_ref(
                   q, x, i, m, wproj, bproj, HEADS, SCALE),
               lambda q=qkv, x=x, i=idx, m=mask: take_tokens(x, i) + F.linear(
                   library_rect(q, i, m), wproj, bproj))


def train_cases(dtype, gen):
    """(kernel name, shape label, kernel call, plain call, library call)
    of the training counterparts at the training widths. Each call returns
    the forward outputs and every gradient for a fixed random cotangent
    (and a non-zero row0 cotangent): the kernel through the autograd
    wrapper, the plain version through the plain forward and the plain
    hand-written backward, the library composition through autograd."""
    B = BATCH[dtype]
    p = block_params(dtype, gen)

    def case(name, x, dy, drow0):
        attn = name == "attend_branch_train"
        ps = [p[k] for k in (ATTN if attn else MLP)]
        leaves = [t.detach().requires_grad_() for t in (x, *ps)]
        cots = (dy, drow0) if attn else (dy,)

        def grads_of(fn):
            outs = as_list(fn(*leaves))
            return [*outs, *torch.autograd.grad(outs, leaves, cots)]

        if attn:
            return (lambda: grads_of(
                        lambda *a: attend_branch_train(*a, HEADS, SCALE, EPS)),
                    lambda: [*attend_branch_train_ref(x, *ps, HEADS, SCALE,
                                                      EPS),
                             *attend_branch_train_bwd_ref(
                                 x, *ps[:5], dy, drow0, HEADS, SCALE, EPS)],
                    lambda: grads_of(library_attention))
        return (lambda: grads_of(lambda *a: mlp_branch(*a, EPS)),
                lambda: [mlp_branch_ref(x, *ps, EPS),
                         *mlp_branch_bwd_ref(x, *ps[:5], dy, EPS)],
                lambda: grads_of(library_mlp))

    def core_case(qkv, bias, dout, drow0, dcs, mask=None):
        """The attention core over views of a packed qkv, as Attention
        calls it, with the size bias (ToMe) or the validity mask
        (heuristic) and the cotangents of all three outputs (the library
        composition has no column mass and takes no colsum cotangent)."""
        leaf = qkv.detach().requires_grad_()
        q, k, v = packed_heads(leaf, HEADS)
        b = None if bias is None else bias.detach().requires_grad_()
        inputs = (q, k, v) + (() if b is None else (b,))
        cots = (dout, drow0, dcs)

        def kernel():
            outs = attention_core_train(q, k, v, SCALE, b, mask)
            return [*outs, *torch.autograd.grad(outs, inputs, cots)]

        def plain():
            dq, dk, dv, db = attention_core_train_bwd_ref(
                q.detach(), k.detach(), v.detach(), bias, dout, drow0, dcs,
                SCALE, mask)
            fwd = fused_attention_ref(q.detach(), k.detach(), v.detach(),
                                      SCALE, bias=bias, mask=mask)
            dbias = [] if bias is None else [db.sum(1).to(bias.dtype)]
            return [*fwd, dq, dk, dv, *dbias]

        def library():
            o, row0, _ = library_core(q, k, v, SCALE, b, mask)
            return [o, row0, *torch.autograd.grad((o, row0), inputs,
                                                  cots[:2])]

        return kernel, plain, library

    for N in TRAIN_N:
        x = torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)
        dy = torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)
        drow0 = torch.randn(B, HEADS, N, generator=gen).to(DEVICE)
        for name in ("attend_branch_train", "mlp_branch"):
            yield (name, f"B={B} N={N}", *case(name, x, dy, drow0))
        qkv = torch.randn(B, N, 3 * D, generator=gen).to(DEVICE, dtype)
        dout = torch.randn(B, N, HEADS, D // HEADS, generator=gen) \
            .to(DEVICE, dtype).transpose(1, 2)  # as merging the heads sends it
        dcs = torch.randn(B, HEADS, N, generator=gen).to(DEVICE)
        yield ("attention_core_train", f"B={B} N={N}",
               *core_case(qkv, log_sizes(B, N, gen, dtype), dout, drow0, dcs))
    # heuristic's masked core at N=197: its first and last active masks
    N = 197
    masks = heuristic_block_masks()
    for blk in HEURISTIC_BLOCKS:
        qkv = torch.randn(B, N, 3 * D, generator=gen).to(DEVICE, dtype)
        dout = torch.randn(B, N, HEADS, D // HEADS, generator=gen) \
            .to(DEVICE, dtype).transpose(1, 2)
        drow0, dcs = (torch.randn(B, HEADS, N, generator=gen).to(DEVICE)
                      for _ in range(2))
        valid = int(masks[blk].sum()) - 1
        yield ("attention_core_train",
               f"B={B} N={N} mask, block {blk}: {valid} patches valid",
               *core_case(qkv, None, dout, drow0, dcs,
                          batch_mask(masks[blk], B)))
    # the distilled DeiT-S's branches: CLS, the dist token and 196 patches
    N = DISTILLED_N
    x = torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)
    dy = torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)
    drow0 = torch.randn(B, HEADS, N, generator=gen).to(DEVICE)
    for name in ("attend_branch_train", "mlp_branch"):
        yield (name, f"B={B} N={N} distilled", *case(name, x, dy, drow0))


def core_forward(q, k, v, bias=None, mask=None):
    """The training core's bf16 forward launch over [B, H, N, hd] views:
    (out, row0, colsum, stats), the residuals its backward reads."""
    B, H, N, hd = q.shape
    out = torch.empty(B, N, H, hd, device=DEVICE, dtype=q.dtype) \
        .transpose(1, 2)
    row0 = torch.empty(B, H, N, device=DEVICE)
    colsum = torch.empty_like(row0)
    stats = torch.empty(B, H, N, 2, device=DEVICE)
    _build.short_attention_heads(q, k, v, out, SCALE, bias=bias, mask=mask,
                                 row0=row0, colsum=colsum, stats=stats)
    return out, row0, colsum, stats


def as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, that over max|want|) after checking shape and dtype."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    abs_err = (got.float() - want.float()).abs().max().item()
    return abs_err, abs_err / max(want.float().abs().max().item(), 1e-30)


def launcher_cases(gen):
    """(launch, shape label, [(output label, got, want)]) for each bf16
    launch of the main path alone, at B=256 and the main path's widths.
    Each launch reads the plain version's inputs."""
    bf16, B = torch.bfloat16, BATCH[torch.bfloat16]
    p = block_params(bf16, gen)

    def ln_ref(rows):  # plain LN2 of rows (bf16 or fp32), rounded to bf16
        return layer_norm_f32(rows.float(), p["ls2"], p["lb2"], EPS).to(bf16)

    def ln_case(rows, M, **gather):
        got = torch.empty(M, D, device=DEVICE, dtype=bf16)
        _build.layer_norm(rows, p["ls2"], p["lb2"], got, eps=EPS, **gather)
        return got

    def gemm_case(x, w, b, y_dtype, **kw):
        n_out = w.shape[1] if kw.get("w_kn") else w.shape[0]
        got = torch.empty(x.shape[0], n_out, device=DEVICE, dtype=y_dtype)
        _build.gemm(x, w, b, got, **kw)
        return got

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen).to(DEVICE, dtype)

    for N in FULL_BLOCK_N:
        M, shape = B * N, f"B={B} N={N}"
        x = randn(M, D)
        x32 = randn(M, D, dtype=torch.float32)
        for label, rows in (("bf16 rows", x), ("fp32 rows", x32)):
            yield f"layer_norm, {label}", shape, [
                ("ln", ln_case(rows, M), ln_ref(rows))]

        ln = ln_ref(x)
        want_qkv = linear_f32(ln, p["wqkv"], p["bqkv"]).to(bf16)
        yield "gemm qkv", shape, [
            ("qkv", gemm_case(ln, p["wqkv"], p["bqkv"], bf16), want_qkv)]

        qkv = want_qkv.view(B, N, 3 * D)
        merged = torch.empty(B, N, D, device=DEVICE, dtype=bf16)
        row0 = torch.empty(B, HEADS, N, device=DEVICE)
        colsum = torch.empty_like(row0)
        _build.short_attention(qkv, merged, HEADS, SCALE, row0=row0,
                               colsum=colsum)
        want = attention_ref(qkv, HEADS, SCALE)
        yield "short_attention", shape, list(zip(
            ("merged heads", "row0", "colsum"), (merged, row0, colsum), want))

        heads = want[0].view(M, D)
        yield "gemm proj, fp32 out", shape, [
            ("y", gemm_case(heads, p["wproj"], p["bproj"], torch.float32),
             linear_f32(heads, p["wproj"], p["bproj"]))]

        h = F.gelu(linear_f32(ln, p["w1"], p["b1"])).to(bf16)
        yield "gemm fc1+GELU", shape, [
            ("hidden", gemm_case(ln, p["w1"], p["b1"], bf16,
                                 gelu=_build.Gelu.ERF), h)]

        yield "gemm fc2, fp32 out", shape, [
            ("out", gemm_case(h, p["w2"], p["b2"], torch.float32),
             linear_f32(h, p["w2"], p["b2"]))]

        if N not in TRAIN_N:
            continue
        # the training launches
        merged = torch.empty(B, N, D, device=DEVICE, dtype=bf16)
        _build.short_attention(qkv, merged, HEADS, SCALE, row0=row0,
                               norm_p=True)
        yield "short_attention, normalised P", shape, list(zip(
            ("merged heads", "row0"), (merged, row0),
            attention_train_ref(qkv, HEADS, SCALE)))

        # the backward reads the forward's output, row0 and statistics
        stats = torch.empty(B, HEADS, N, 2, device=DEVICE)
        _build.short_attention(qkv, merged, HEADS, SCALE, row0=row0,
                               stats=stats, norm_p=True)
        dout, drow0 = randn(B, N, D), randn(B, HEADS, N, dtype=torch.float32)
        dqkv = torch.empty_like(qkv)
        _build.short_attention_bwd(qkv, merged, dout, drow0, dqkv, HEADS,
                                   SCALE, stats=stats, row0=row0)
        want = attention_bwd_ref(qkv, dout, drow0, HEADS, SCALE)
        yield "short_attention_bwd", shape, [
            (label, dqkv[..., i * D:(i + 1) * D], want[..., i * D:(i + 1) * D])
            for i, label in enumerate(("dq", "dk", "dv"))]

        # ToMe's launches: the biased forward, the head-mean keys, and the
        # biased backward over [B, H, N, hd] views with both cotangents
        bias = log_sizes(B, N, gen, torch.float32)
        _build.short_attention(qkv, merged, HEADS, SCALE, bias=bias,
                               row0=row0, colsum=colsum)
        yield "short_attention, bias", shape, list(zip(
            ("merged heads", "row0", "colsum"), (merged, row0, colsum),
            attention_ref(qkv, HEADS, SCALE, bias)))
        keys = torch.empty(B, N, D // HEADS, device=DEVICE, dtype=bf16)
        _build.head_mean_keys(qkv, keys, HEADS)
        yield "head_mean_keys", shape, [
            ("keys", keys, head_mean_keys_ref(qkv, HEADS))]
        q, k, v = packed_heads(qkv, HEADS)
        out, row0, _, stats = core_forward(q, k, v, bias=bias)
        yield "short_attention, bias, stats", shape, list(zip(
            ("row max", "1/sum"), stats.unbind(-1),
            stats_ref(q, k, bias=bias).unbind(-1)))
        dout = randn(B, N, HEADS, D // HEADS).transpose(1, 2)
        dcs = randn(B, HEADS, N, dtype=torch.float32)
        grads = torch.empty(3, B, HEADS, N, D // HEADS, device=DEVICE,
                            dtype=bf16).unbind(0)
        dbias = torch.empty(B, HEADS, N, device=DEVICE)
        _build.short_attention_bwd_heads(q, k, v, out, dout, *grads, SCALE,
                                         stats=stats, row0=row0, bias=bias,
                                         drow0=drow0, dcs=dcs, dbias=dbias)
        yield "short_attention_bwd, bias, colsum cotangent, dbias", shape, \
            list(zip(("dq", "dk", "dv", "dbias"), (*grads, dbias),
                     attention_core_train_bwd_ref(q, k, v, bias, dout, drow0,
                                                  dcs, SCALE)))

        dy = randn(M, D)
        yield "gemm dY.W (W untransposed)", shape, [
            ("dattn", gemm_case(dy, p["wproj"], None, bf16, w_kn=True),
             (dy.float() @ p["wproj"].float()).to(bf16))]
        dq = dqkv.view(M, 3 * D)
        yield "gemm dY.W, fp32 out", shape, [
            ("dln", gemm_case(dq, p["wqkv"], None, torch.float32, w_kn=True),
             dq.float() @ p["wqkv"].float())]

        a = torch.empty(M, H4, device=DEVICE, dtype=bf16)
        gp = torch.empty(M, H4, device=DEVICE)
        _build.gemm(ln, p["w1"], p["b1"], a, gelu=_build.Gelu.ERF,
                    gelu_grad=gp)
        pre = linear_f32(ln, p["w1"], p["b1"])
        yield "gemm fc1+GELU, GELU' out", shape, [
            ("hidden", a, F.gelu(pre).to(bf16)), ("GELU'", gp, gelu_grad(pre))]

        parts = torch.empty(-(-M // _build.GEMM_TILE), H4, device=DEVICE)
        dh = gemm_case(dy, p["w2"], None, bf16, w_kn=True, mul=gp,
                       col_sums=parts)
        dh32 = (dy.float() @ p["w2"].float()) * gp
        yield "gemm dY.W x GELU', column sums", shape, [
            ("dh", dh, dh32.to(bf16)), ("db1", parts.sum(0), dh32.sum(0))]

        dw = torch.empty(3 * D, D, device=DEVICE, dtype=bf16)
        db = torch.empty(3 * D, device=DEVICE, dtype=bf16)
        _build.sum_partials_many(_build.gemm_wgrad(dq, ln, dw, db))
        yield "gemm_wgrad", shape, [
            ("dW", dw, (dq.float().T @ ln.float()).to(bf16)),
            ("db", db, dq.float().sum(0).to(bf16))]

        dln = randn(M, D, dtype=torch.float32)
        dx = torch.empty_like(x)
        dwb = torch.empty(2, D, device=DEVICE, dtype=bf16)
        _build.sum_partials_many(
            _build.layer_norm_bwd(x, p["ls1"], dln, dx, dwb, eps=EPS))
        x_hat, rstd = layer_norm_stats(x.float(), EPS)
        want = layer_norm_bwd_ref(dln, x_hat, rstd, p["ls1"])
        yield "layer_norm_bwd", shape, [
            (label, got, w.to(bf16)) for label, got, w in
            zip(("dx", "d scale", "d bias"), (dx, dwb[0], dwb[1]), want)]

    for N, K in MLP_GATHER_NK:
        x = randn(B, N, D)
        idx = torch.stack([torch.randperm(N, generator=gen)[:K]
                           for _ in range(B)]).to(DEVICE, torch.int32)
        got = ln_case(x.view(B * N, D), B * K, idx=idx, rows_out=K,
                      rows_in=N)
        want = ln_ref(take_tokens(x, idx.long()).view(B * K, D))
        yield "layer_norm, gathered rows", f"B={B} N={N} K={K}", [
            ("ln", got, want)]

    # ATS's launches: the masked attention (eval and normalised-P), the
    # rectangular attention and the out projection with the residual
    # gathered through the kept ids
    for N in ATS_N:
        shape = f"B={B} N={N}"
        qkv = randn(B, N, 3 * D)
        mask = token_mask(B, N, gen)
        merged = torch.empty(B, N, D, device=DEVICE, dtype=bf16)
        row0 = torch.empty(B, HEADS, N, device=DEVICE)
        colsum = torch.empty_like(row0)
        for norm_p in (False, True):
            _build.short_attention(qkv, merged, HEADS, SCALE, mask=mask,
                                   row0=row0, colsum=colsum, norm_p=norm_p)
            yield (f"short_attention, mask{', normalised P' * norm_p}",
                   shape, list(zip(("merged heads", "row0", "colsum"),
                                   (merged, row0, colsum),
                                   attention_ref(qkv, HEADS, SCALE, mask=mask,
                                                 norm_p=norm_p))))
    for M, N in RECT_MN:
        shape = f"B={B} N={N} M={M}"
        qkv, x = randn(B, N, 3 * D), randn(B, N, D)
        mask = token_mask(B, N, gen)
        idx = kept_ids(B, N, M, mask, gen)
        ids = idx.to(torch.int32)
        merged = torch.empty(B, M, D, device=DEVICE, dtype=bf16)
        _build.short_attention(qkv, merged, HEADS, SCALE, mask=mask, ids=ids)
        want = rect_attention_ref(qkv, idx, mask, HEADS, SCALE)
        yield "short_attention, rectangular", shape, [
            ("merged heads", merged, want)]
        got = torch.empty(B * M, D, device=DEVICE, dtype=bf16)
        _build.gemm(want.view(B * M, D), p["wproj"], p["bproj"], got,
                    res=x.view(B * N, D), idx=ids, rows_out=M, rows_in=N)
        yield "gemm proj + gathered residual", shape, [
            ("out", got, (take_tokens(x, idx).float() + linear_f32(
                want, p["wproj"], p["bproj"])).to(bf16).view(B * M, D))]

    # heuristic's launch: the masked backward over [B, H, N, hd] views at
    # N=197, without the by-products' cotangents (the train step's
    # variant: heuristic reads neither row0 nor colsum) and with them
    N, hd = 197, D // HEADS
    masks = heuristic_block_masks()
    q, k, v = packed_heads(randn(B, N, 3 * D), HEADS)
    dout = randn(B, N, HEADS, hd).transpose(1, 2)
    drow0, dcs = (randn(B, HEADS, N, dtype=torch.float32) for _ in range(2))
    for blk in HEURISTIC_BLOCKS:
        mask = batch_mask(masks[blk], B)
        out, row0, _, stats = core_forward(q, k, v, mask=mask)
        # the statistics the masked core saves (the eval recipe): a fully
        # masked row keeps the JAX pair mask's -FLT_MAX as its max, exactly
        # (the rows are uniform over all N keys); the other rows' max and
        # every row's 1/sum against their own max
        want = stats_ref(q, k, mask=mask)
        dead = ~mask[:, None, :].expand(-1, HEADS, -1)
        require(bool((stats[..., 0][dead] == MASK_VALUE).all()),
                f"short_attention, mask, stats block {blk}: a fully masked "
                f"row's max is not -FLT_MAX")
        yield "short_attention, mask, stats", f"B={B} N={N} block {blk}", [
            ("row max, rows with a valid key", stats[..., 0][~dead],
             want[..., 0][~dead]),
            ("1/sum", stats[..., 1], want[..., 1])]
        for cots in ({}, dict(drow0=drow0, dcs=dcs)):
            grads = torch.empty(3, B, HEADS, N, hd, device=DEVICE,
                                dtype=bf16).unbind(0)
            _build.short_attention_bwd_heads(q, k, v, out, dout, *grads,
                                             SCALE, stats=stats, row0=row0,
                                             mask=mask, **cots)
            want = attention_core_train_bwd_ref(
                q, k, v, None, dout, cots.get("drow0"), cots.get("dcs"),
                SCALE, mask)
            label = "short_attention_bwd, mask" + (
                ", row0 and colsum cotangents" if cots else "")
            yield label, f"B={B} N={N} block {blk}", list(zip(
                ("dq", "dk", "dv"), grads, want))


def phase_launchers():
    """Phase 2, second part: each bf16 launch alone against its plain
    version, relative to the tensor's own max."""
    worst = {}
    for launch, shape, outputs in launcher_cases(
            torch.Generator().manual_seed(4)):
        errs = []
        for label, got, want in outputs:
            abs_err, rel = rel_err(got, want)
            bound_ = LAUNCH_BOUND[got.dtype]
            require(rel <= bound_, f"{launch} bf16 {shape} {label}: error "
                    f"{rel:.3e} of its max|plain| > bound {bound_:.0e}")
            errs.append(f"{label} {abs_err:.3e} ({rel:.2e} of max, bound "
                        f"{bound_:.0e})")
            key = f"{launch}: {label}"
            worst[key] = max(worst.get(key, 0.0), rel)
        print(f"phase 2 launch {launch} bf16 {shape}: {', '.join(errs)}",
              flush=True)
    for key, rel in worst.items():
        print(f"phase 2 launch worst {key}: {rel:.2e} of its max|plain|",
              flush=True)


# the bf16 GEMM's launches alone (csrc/gemm_sm90.cu), at DeiT-S's widths:
# (tag, rows M, None or the gathered residual's (K kept rows, N rows) a
# sample): B = 256 (M = 50,432 rows, the main path's); B = 32 (M = 6304
# rows, no multiple of 128 row tiles nor of 64-row K steps for the weight
# gradient); topk@0.25's last stage at B = 256 (4 tokens: M = 1024, 8 row
# tiles, the smallest shape of the main path; forward only, and the MLP
# gathering its 4 rows of 13)
GEMM_SHAPES = (("B=256", 256 * 197, None), ("B=32", 32 * 197, None),
               ("topk@0.25 last stage B=256", 256 * 4, (4, 13)))
# dense bf16 operations a clock of one H100 SM (4 tensor cores of 1024)
SM_FLOP_PER_CLOCK = 4096


def per_launch_ms(fn) -> float:
    """CUDA-event time of one of ten back-to-back launches of fn (median
    of 20 runs), in ms: the host's launch cost stays hidden."""
    def ten():
        for _ in range(10):
            fn()
    return cuda_ms(ten) / 10


def gemm_cases(M, gen, gather=None):
    """(launch, label, run, [(output label, got or a call that reads it,
    want)], flops, bytes, library call or None, plain call) for each GEMM
    of a DeiT-S block at M token rows: the forward's four products (the
    training fc1 also with GELU'), the backward's four dY . W products and
    the four weight gradients, each with the epilogue its counterpart asks
    for. With ``gather`` (K, N), the forward's products only, the training
    fc1 left out, and fc2 also with the residual row m gathered from row
    (m // K) * N + idx[m] of the stage's input, as the gathered MLP reads
    it. bytes: each input read once, each output written once."""
    bf16, f32 = torch.bfloat16, torch.float32
    p = block_params(bf16, gen)
    # the activations are drawn on the card: on the host they take seconds
    dev_gen = torch.Generator(device=DEVICE).manual_seed(M)

    def rn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=dev_gen, device=DEVICE).to(dtype)

    def empty(*shape, dtype=bf16):
        return torch.empty(*shape, device=DEVICE, dtype=dtype)

    ln, heads, h, dy, dq, dh = (rn(M, D), rn(M, D), rn(M, H4), rn(M, D),
                                rn(M, 3 * D), rn(M, H4))
    res, gp = rn(M, D), rn(M, H4, dtype=f32)
    E = 2
    forward = [("qkv", ln, "wqkv", "bqkv", 3 * D, {}, True),
               ("proj + residual", heads, "wproj", "bproj", D, dict(res=res),
                False),
               ("fc1 + GELU", ln, "w1", "b1", H4,
                dict(gelu=_build.Gelu.ERF), False),
               ("fc1 + GELU, GELU' out", ln, "w1", "b1", H4,
                dict(gelu=_build.Gelu.ERF,
                     gelu_grad=empty(M, H4, dtype=f32)), False),
               ("fc2 + residual", h, "w2", "b2", D, dict(res=res), False)]
    if gather:
        K, N = gather
        stage = rn(M // K * N, D)
        idx = torch.randint(0, N, (M,), generator=dev_gen, device=DEVICE,
                            dtype=torch.int32)
        rows = (torch.arange(M, device=DEVICE) // K) * N + idx
        forward[3] = ("fc2 + gathered residual", h, "w2", "b2", D,
                      dict(res=stage, idx=idx, rows_out=K, rows_in=N), False)
    for label, x, w, b, n_out, kw, library in forward:
        w, b = p[w], p[b]
        y = empty(M, n_out)
        pre = linear_f32(x, w, b)
        want = [F.gelu(pre) if kw.get("gelu") else pre]
        if "idx" in kw:
            want[0] = want[0] + kw["res"][rows].float()
        elif "res" in kw:
            want[0] = want[0] + res.float()
        outs = [("y", y, want[0].to(bf16))]
        nbytes = E * (x.numel() + w.numel() + b.numel() + y.numel()) + (
            E * M * D if "res" in kw else 0) + (4 * M if "idx" in kw else 0)
        if "gelu_grad" in kw:
            outs.append(("GELU'", kw["gelu_grad"], gelu_grad(pre)))
            nbytes += 4 * kw["gelu_grad"].numel()
        yield ("gemm", label, lambda x=x, w=w, b=b, y=y, kw=kw: _build.gemm(
            x, w, b, y, **kw), outs, 2 * M * x.shape[1] * n_out, nbytes,
            (lambda x=x, w=w, b=b: F.linear(x, w, b)) if library else None,
            lambda x=x, w=w, b=b: linear_f32(x, w, b))
    if gather:
        return
    # the backward's dY . W with W read untransposed ([n_out, K] is the
    # product's [K, n]): fp32 out where LN's backward reads it
    parts = empty(-(-M // 128), H4, dtype=f32)
    for label, g, w, y_dtype, kw, library in (
            ("qkv dY.W, fp32 out", dq, "wqkv", f32, {}, False),
            ("proj dY.W", dy, "wproj", bf16, {}, True),
            ("fc2 dY.W x GELU', column sums", dy, "w2", bf16,
             dict(mul=gp, col_sums=parts), False),
            ("fc1 dY.W, fp32 out", dh, "w1", f32, {}, False)):
        w = p[w]
        y = empty(M, w.shape[1], dtype=y_dtype)
        want = g.float() @ w.float()
        if "mul" in kw:
            want = want * gp
        outs = [("y", y, want.to(y_dtype))]
        nbytes = E * (g.numel() + w.numel()) + y.element_size() * y.numel()
        if "mul" in kw:
            # the per-row-tile sums, summed over the tiles after the launch
            outs.append(("column sums", lambda: parts.sum(0), want.sum(0)))
            nbytes += 4 * (gp.numel() + parts.numel())
        yield ("gemm", label, lambda g=g, w=w, y=y, kw=kw: _build.gemm(
            g, w, None, y, w_kn=True, **kw), outs, 2 * M * w.numel(), nbytes,
            (lambda g=g, w=w: torch.matmul(g, w)) if library else None,
            lambda g=g, w=w: g.float() @ w.float())
    for label, g, x, with_db in (("qkv", dq, ln, True),
                                 ("proj", dy, heads, True),
                                 ("fc1", dh, ln, False),
                                 ("fc2", dy, h, True)):
        n_out, K = g.shape[1], x.shape[1]
        dw = empty(n_out, K)
        db = empty(n_out) if with_db else None
        outs = [("dW", dw, (g.float().T @ x.float()).to(bf16))]
        if with_db:
            outs.append(("db", db, g.float().sum(0).to(bf16)))
        yield ("gemm_wgrad", label + (" + db" if with_db else ""),
               lambda g=g, x=x, dw=dw, db=db: _build.sum_partials_many(
                   _build.gemm_wgrad(g, x, dw, db)),
               outs, 2 * M * n_out * K,
               E * (g.numel() + x.numel() + dw.numel()) + (
                   E * n_out if with_db else 0),
               lambda g=g, x=x: torch.matmul(g.t(), x),
               lambda g=g, x=x: g.float().T @ x.float())


def max_sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(mhz) * 1e6


def phase_gemms() -> dict:
    """Phase 2, last part: each bf16 GEMM launch alone at every shape of
    GEMM_SHAPES, against its fp32 plain version (bf16 outputs within 1e-2
    of their own max, fp32 ones 1e-4), with its time per launch beside its
    bound, its TFLOP/s and, where one PyTorch call computes the same
    function, that call's time. A rate above the tensor cores' dense peak
    at the card's highest SM clock means a mistimed launch or skipped
    products, and fails. Returns the JSON records of gemm and gemm_wgrad
    (the qkv shape at B = 256)."""
    gen = torch.Generator().manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ceiling = sms * SM_FLOP_PER_CLOCK * max_sm_clock_hz()
    print(f"phase 2 gemm: dense bf16 ceiling {ceiling / 1e12:.1f} TFLOP/s "
          f"({sms} SMs at the highest SM clock)", flush=True)
    rec = {}
    for tag, M, gather in GEMM_SHAPES:
        for launch, label, run, outs, flops, nbytes, library, plain in \
                gemm_cases(M, gen, gather):
            run()
            torch.cuda.synchronize()
            errs, worst = [], 0.0
            for name, got, want in outs:
                got = got() if callable(got) else got
                abs_err, rel = rel_err(got, want)
                bound_ = LAUNCH_BOUND[got.dtype]
                require(rel <= bound_, f"{launch} {label} {tag} {name}: "
                        f"error {rel:.3e} of its max|plain| > bound "
                        f"{bound_:.0e}")
                errs.append(f"{name} {abs_err:.3e} ({rel:.2e} of max, bound "
                            f"{bound_:.0e})")
                worst = max(worst, abs_err)
            ms = per_launch_ms(run)
            lib_ms = per_launch_ms(library) if library else None
            t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
            bound_ms = max(t_ops, t_bytes) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
            rate = flops / ms * 1e3
            print(f"phase 2 gemm {launch} {label} {tag} M={M}: "
                  f"{', '.join(errs)}; kernel {ms:.4f} ms per launch "
                  f"({rate / 1e12:.1f} TFLOP/s), bound {bound_ms:.4f} "
                  f"ms ({bound_by}), library {lib}", flush=True)
            require(rate <= ceiling, f"{launch} {label} {tag}: "
                    f"{rate / 1e12:.1f} TFLOP/s is above the ceiling")
            if tag == GEMM_SHAPES[0][0] and launch not in rec:
                rec[launch] = dict(shape=f"bf16 {label} M={M}", ms=ms,
                                   plain_ms=per_launch_ms(plain),
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=lib_ms, max_abs_err=worst)
    return rec


# the sm_90a attention's launches alone (csrc/attention_sm90.cu): B = 256
# at topk@0.7's widths and topk@0.25's, and B = 32 at 197
ATTENTION_SHAPES = tuple((256, n) for n in (197, 138, 97, 68, 50, 13, 4)) \
    + ((32, 197),)


def stats_ref(q, k, bias=None, mask=None):
    """The row statistics [B, H, N, 2] fp32 that the training forwards
    write: the row max of the logits (the JAX pair mask's -FLT_MAX kept)
    and 1/sum of their exponentials."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * SCALE
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    if mask is not None:
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        logits = logits.masked_fill(~pair, MASK_VALUE)
    m = logits.amax(-1)
    return torch.stack([m, 1.0 / torch.exp(logits - m[..., None]).sum(-1)],
                       -1)


def sdpa_backward(q, k, v, dout, attn_mask=None):
    """A call that runs SDPA's backward alone (autograd over leaf copies of
    q, k, v, the forward run once here): the nearest library call of the
    attention backward (no row0 or colsum by-products, no dbias)."""
    with torch.enable_grad():  # also under a caller's no_grad
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask,
                                             scale=SCALE)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def attention_cases(B, N, gen):
    """(launch, variant, run, [(output label, got, want)], flops, bytes,
    library call, plain call) for each variant of the sm_90a attention that
    the main path launches, at B images of N tokens: the eval forward
    without and with the by-products (and with ToMe's bias, ATS's and
    heuristic's mask), the training branch's normalised-P forward with its
    statistics, and the backward of the branch (row0 cotangent), of ToMe's
    core (bias, colsum cotangent, dbias: the exact-delta variant) and of
    heuristic's masked core. bytes: those of the function, each of its
    inputs read once and each of its outputs written once: the forward's
    output, row0 and row statistics that the port's backward reads, and
    the statistics that its training forward writes for it, are residuals
    of the port's design (JAX's kernels read and write none of them) and
    do not count. The forward's statistics are held as two outputs, the
    row max and 1/sum, each against its own max. The library call is SDPA on the
    same q, k, v with the bias or the pair mask as a float mask: the
    output alone, no by-products."""
    bf16 = torch.bfloat16
    dev_gen = torch.Generator(device=DEVICE).manual_seed(B * 1000 + N)

    def rn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=dev_gen, device=DEVICE).to(dtype)

    qkv = rn(B, N, 3 * D)
    q, k, v = packed_heads(qkv, HEADS)
    bias = log_sizes(B, N, gen, torch.float32)
    mask = token_mask(B, N, gen)
    merged = torch.empty(B, N, D, device=DEVICE, dtype=bf16)
    row0 = torch.empty(B, HEADS, N, device=DEVICE)
    colsum = torch.empty_like(row0)
    stats = torch.empty(B, HEADS, N, 2, device=DEVICE)
    E, vec = 2, 4 * B * HEADS * N
    io = E * 4 * B * N * D  # q, k, v in, the output out
    fwd_flops = 4 * B * N * N * D
    by_products = ("merged heads", "row0", "colsum"), (merged, row0, colsum)
    for label, kw, (names, outs), want_fn, extra, lib_mask in (
            ("forward", {}, (("merged heads",), (merged,)),
             lambda: attention_ref(qkv, HEADS, SCALE)[:1], 0, None),
            ("forward, row0 + colsum", dict(row0=row0, colsum=colsum),
             by_products, lambda: attention_ref(qkv, HEADS, SCALE), 2 * vec,
             None),
            ("forward, bias, row0 + colsum",
             dict(bias=bias, row0=row0, colsum=colsum), by_products,
             lambda: attention_ref(qkv, HEADS, SCALE, bias),
             2 * vec + 4 * B * N, float_mask(bf16, bias)),
            ("forward, mask, row0 + colsum",
             dict(mask=mask, row0=row0, colsum=colsum), by_products,
             lambda: attention_ref(qkv, HEADS, SCALE, mask=mask),
             2 * vec + B * N, float_mask(bf16, None, mask, mask)),
            ("forward, normalised P, row0, stats",
             dict(row0=row0, stats=stats, norm_p=True),
             (("merged heads", "row0", "row max", "1/sum"),
              (merged, row0, *stats.unbind(-1))),
             lambda: (*attention_train_ref(qkv, HEADS, SCALE),
                      *stats_ref(q, k).unbind(-1)), vec, None)):
        want = want_fn()
        yield ("short_attention", label,
               lambda kw=kw: _build.short_attention(qkv, merged, HEADS, SCALE,
                                                    **kw),
               list(zip(names, outs, want)), fwd_flops, io + extra,
               lambda m=lib_mask: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=m, scale=SCALE), want_fn)
    # the backward: the branch's (packed qkv, the row0 cotangent)
    _build.short_attention(qkv, merged, HEADS, SCALE, row0=row0, stats=stats,
                           norm_p=True)
    dout, drow0 = rn(B, N, D), rn(B, HEADS, N, dtype=torch.float32)
    dcs = rn(B, HEADS, N, dtype=torch.float32)
    dqkv = torch.empty_like(qkv)
    bwd_flops = 10 * B * N * N * D  # S, dP, dV, dK, dQ
    bwd_io = E * 7 * B * N * D  # q, k, v, dout in; dq, dk, dv out
    want = attention_bwd_ref(qkv, dout, drow0, HEADS, SCALE)
    yield ("short_attention_bwd", "backward, row0 cotangent",
           lambda: _build.short_attention_bwd(qkv, merged, dout, drow0, dqkv,
                                              HEADS, SCALE, stats=stats,
                                              row0=row0),
           [(n, lambda i=i: dqkv[..., i * D:(i + 1) * D],
             want[..., i * D:(i + 1) * D])
            for i, n in enumerate(("dq", "dk", "dv"))],
           bwd_flops, bwd_io + vec,  # drow0 in
           sdpa_backward(q, k, v, merged_heads(dout, HEADS)),
           lambda: attention_bwd_ref(qkv, dout, drow0, HEADS, SCALE))
    # the core's, over [B, H, N, hd] views: ToMe's (bias, both cotangents,
    # dbias) and heuristic's (mask, no cotangents)
    hd = D // HEADS
    dout_h = rn(B, N, HEADS, hd).transpose(1, 2)
    grads = torch.empty(3, B, HEADS, N, hd, device=DEVICE,
                        dtype=bf16).unbind(0)
    dbias = torch.empty(B, HEADS, N, device=DEVICE)
    for label, fw, kw, extra, lib_mask in (
            ("backward, bias, colsum cotangent, dbias", dict(bias=bias),
             dict(bias=bias, drow0=drow0, dcs=dcs, dbias=dbias),
             3 * vec + 4 * B * N, float_mask(bf16, bias)),  # + bias
            ("backward, mask", dict(mask=mask), dict(mask=mask),
             B * N, float_mask(bf16, None, mask, mask))):
        out, r0, _, st = core_forward(q, k, v, **fw)
        want = attention_core_train_bwd_ref(
            q, k, v, kw.get("bias"), dout_h, kw.get("drow0"), kw.get("dcs"),
            SCALE, kw.get("mask"))
        names = ("dq", "dk", "dv", "dbias")[:4 if "dbias" in kw else 3]
        yield ("short_attention_bwd", label,
               lambda out=out, r0=r0, st=st, kw=kw:
               _build.short_attention_bwd_heads(q, k, v, out, dout_h, *grads,
                                                SCALE, stats=st, row0=r0,
                                                **kw),
               list(zip(names, (*grads, dbias), want)), bwd_flops,
               bwd_io + extra, sdpa_backward(q, k, v, dout_h, lib_mask),
               lambda kw=kw: attention_core_train_bwd_ref(
                   q, k, v, kw.get("bias"), dout_h, kw.get("drow0"),
                   kw.get("dcs"), SCALE, kw.get("mask")))


def check_rect_rows(merged, qkv, idx, mask, tag):
    """The rectangular attention's special rows: a slot padded with the CLS
    row gives the CLS slot's output bit for bit, and the dead slot 1 (a
    fully masked query row) is uniform over the N keys: the mean of the
    values, within 1e-2 (bf16) or 1e-4 (fp32) of its max."""
    pads = idx == 0
    pads[:, 0] = False
    require(bool((merged == merged[:, :1]).all(-1)[pads].all()),
            f"rect_attention {tag}: a padded slot differs from the CLS slot")
    dead = ~torch.gather(mask, 1, idx[:, 1:2])[:, 0]
    require(bool(dead.any()), f"rect_attention {tag}: no dead slot")
    uniform = qkv[:, :, 2 * D:].float().mean(1)
    _, rel = rel_err(merged[dead, 1].float(), uniform[dead])
    require(rel <= LAUNCH_BOUND[merged.dtype], f"rect_attention {tag}: a "
            f"fully masked row is {rel:.3e} of its max off the values' mean")
    return int(pads.sum()), int(dead.sum())


def rect_cases(gen):
    """The rectangular attention (the RECT variant of
    csrc/attention_sm90.cu's forward: its query rows gathered by id) at
    ATS's (M, N) and at RECT_WIDE_MN, B = 256, in the form of
    attention_cases; each case's padded and fully masked rows checked
    first (check_rect_rows)."""
    B = 256
    for M, N in (*RECT_MN, RECT_WIDE_MN):
        dev_gen = torch.Generator(device=DEVICE).manual_seed(M * 1000 + N)
        qkv = torch.randn(B, N, 3 * D, generator=dev_gen, device=DEVICE) \
            .to(torch.bfloat16)
        mask = token_mask(B, N, gen)
        idx = kept_ids(B, N, M, mask, gen)
        ids = idx.to(torch.int32)
        merged = torch.empty(B, M, D, device=DEVICE, dtype=torch.bfloat16)
        want = rect_attention_ref(qkv, idx, mask, HEADS, SCALE)
        _build.short_attention(qkv, merged, HEADS, SCALE, mask=mask, ids=ids)
        torch.cuda.synchronize()
        tag = f"B={B} M={M} N={N}"
        pads, dead = check_rect_rows(merged, qkv, idx, mask, tag)
        print(f"phase 2 attention rect_attention {tag}: {pads} padded slots "
              f"equal to CLS, {dead} fully masked rows uniform", flush=True)
        yield ("rect_attention", tag,
               lambda qkv=qkv, merged=merged, mask=mask, ids=ids:
               _build.short_attention(qkv, merged, HEADS, SCALE, mask=mask,
                                      ids=ids),
               [("merged heads", merged, want)], 4 * B * M * N * D,
               2 * (2 * B * N * D + 2 * B * M * D) + 4 * B * M + B * N,
               lambda qkv=qkv, idx=idx, mask=mask: library_rect(qkv, idx,
                                                                mask),
               lambda qkv=qkv, idx=idx, mask=mask: rect_attention_ref(
                   qkv, idx, mask, HEADS, SCALE))


def phase_attention() -> dict:
    """Phase 2, last part: each launch of the attention alone at every
    shape of ATTENTION_SHAPES (and the rectangular one at ATS's (M, N)),
    against its plain version (bf16 outputs within 1e-2 of their own max,
    fp32 ones 1e-4), with its time per launch beside its bound, the
    plain version's time and SDPA's. A rate above the tensor cores' dense
    peak at the card's highest SM clock fails. Returns the JSON records of
    short_attention (the eval forward with row0 and colsum) and
    short_attention_bwd (the branch's) at B = 256, N = 197, and of
    rect_attention at M = 138, N = 197."""
    gen = torch.Generator().manual_seed(6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ceiling = sms * SM_FLOP_PER_CLOCK * max_sm_clock_hz()
    rec = {}
    cases = [(f"B={B} N={N}", case) for B, N in ATTENTION_SHAPES
             for case in attention_cases(B, N, gen)]
    cases += [(case[1], (case[0], "forward, mask") + case[2:])
              for case in rect_cases(gen)]
    for tag, (launch, label, run, outs, flops, nbytes, library, plain) in \
            cases:
        run()
        torch.cuda.synchronize()
        errs, worst = [], 0.0
        for name, got, want in outs:
            got = got() if callable(got) else got
            abs_err, rel = rel_err(got, want)
            bound_ = LAUNCH_BOUND[got.dtype]
            require(rel <= bound_, f"{launch} {label} {tag} {name}: error "
                    f"{rel:.3e} of its max|plain| > bound {bound_:.0e}")
            errs.append(f"{name} {abs_err:.3e} ({rel:.2e} of max)")
            worst = max(worst, abs_err)
        ms = per_launch_ms(run)
        lib_ms = per_launch_ms(library)
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        rate = flops / ms * 1e3
        require(rate <= ceiling, f"{launch} {label} {tag}: "
                f"{rate / 1e12:.1f} TFLOP/s is above the ceiling")
        print(f"phase 2 attention {launch} {label} {tag}: {', '.join(errs)}; "
              f"kernel {ms:.4f} ms per launch ({rate / 1e12:.1f} TFLOP/s), "
              f"bound {bound_ms:.4f} ms ({bound_by}), SDPA {lib_ms:.4f} ms",
              flush=True)
        if tag in ("B=256 N=197", "B=256 M=138 N=197") and label in (
                "forward, row0 + colsum", "backward, row0 cotangent",
                "forward, mask") and launch not in rec:
            rec[launch] = dict(shape=f"bf16 {label} {tag}", ms=ms,
                               plain_ms=per_launch_ms(plain),
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=lib_ms, max_abs_err=worst)
    return rec


# the fp32 forward GEMM (csrc/gemm_tf32_sm90.cu) and the fp32 square
# attention (csrc/short_attention.cu short_attention_tf32_kernel), 3xTF32
# on the tensor cores, each launch alone: B = 256 (the DyViT teacher's and
# the eval batch) and B = 32, N = 197; the gathered residual of #3 at
# topk@0.7's first reduction (197 -> 138 rows) and topk@0.25's last
# (13 -> 4)
FP32_SHAPES = ((256, 197), (32, 197))
FP32_GATHER = ((197, 138), (13, 4))
# dense TF32 operations a clock of one H100 SM (half the bf16 rate)
SM_TF32_FLOP_PER_CLOCK = 2048


def fp32_gemm_cases(B, N, gen):
    """(launch, label, run, [(output label, got, want)], flops, bytes,
    library call, plain call) of each fp32 forward product of a DeiT-S
    block at B x N rows: qkv, proj + residual, fc1 + GELU (eval's, and the
    training forward's with GELU' out), fc2 + residual, and fc2 with #3's
    gathered residual at FP32_GATHER. The library call
    is cuBLAS SGEMM with its bias (F.linear, TF32 off), the product alone.
    bytes: each input read once, each output written once."""
    f32 = torch.float32
    p = block_params(f32, gen)
    dev_gen = torch.Generator(device=DEVICE).manual_seed(B * 1000 + N + 7)

    def rn(*shape):
        return torch.randn(*shape, generator=dev_gen, device=DEVICE)

    def case(label, x, w, b, kw, rows=None):
        M, n_out = x.shape[0], w.shape[0]
        y = torch.empty(M, n_out, device=DEVICE)

        def plain():
            out = linear_f32(x, w, b)
            if kw.get("gelu"):
                out = F.gelu(out)
            if "res" in kw:
                out = out + (kw["res"] if rows is None else kw["res"][rows])
            return out

        outs = [("y", y, plain())]
        if "gelu_grad" in kw:
            outs.append(("GELU'", kw["gelu_grad"],
                         gelu_grad(linear_f32(x, w, b))))
        nbytes = 4 * (x.numel() + w.numel() + b.numel() + y.numel()) + (
            4 * M * n_out if "res" in kw else 0) + (4 * M if rows is not None
                                                    else 0) + (
            4 * M * n_out if "gelu_grad" in kw else 0)
        return ("gemm_tf32", label,
                lambda: _build.gemm(x, w, b, y, **kw), outs,
                2 * M * x.shape[1] * n_out, nbytes,
                lambda: F.linear(x, w, b), plain)

    M = B * N
    ln, h, res = rn(M, D), rn(M, H4), rn(M, D)
    yield case("qkv", ln, p["wqkv"], p["bqkv"], {})
    yield case("proj + residual", ln, p["wproj"], p["bproj"], dict(res=res))
    yield case("fc1 + GELU", ln, p["w1"], p["b1"], dict(gelu=_build.Gelu.ERF))
    yield case("fc1 + GELU, GELU' out", ln, p["w1"], p["b1"],
               dict(gelu=_build.Gelu.ERF,
                    gelu_grad=torch.empty(M, H4, device=DEVICE)))
    yield case("fc2 + residual", h, p["w2"], p["b2"], dict(res=res))
    for n_in, K in FP32_GATHER:
        stage = rn(B * n_in, D)
        idx = torch.randint(0, n_in, (B * K,), generator=dev_gen,
                            device=DEVICE, dtype=torch.int32)
        rows = (torch.arange(B * K, device=DEVICE) // K) * n_in + idx
        yield case(f"fc2 + gathered residual, {n_in} -> {K} rows a sample",
                   rn(B * K, H4),
                   p["w2"], p["b2"],
                   dict(res=stage, idx=idx, rows_out=K, rows_in=n_in), rows)


def fp32_attention_cases(B, N, gen):
    """The same for the fp32 square attention off a packed qkv at B images
    of N tokens: the forward without by-products (the DyViT teacher's),
    with row0 and colsum, with ToMe's bias and with a validity mask. The
    library call is SDPA in fp32 on the same q, k, v (TF32 off), the bias
    or the pair mask as a float mask: the output alone."""
    f32 = torch.float32
    dev_gen = torch.Generator(device=DEVICE).manual_seed(B * 1000 + N + 11)
    qkv = torch.randn(B, N, 3 * D, generator=dev_gen, device=DEVICE)
    q, k, v = packed_heads(qkv, HEADS)
    bias = log_sizes(B, N, gen, f32)
    mask = token_mask(B, N, gen)
    merged = torch.empty(B, N, D, device=DEVICE)
    row0 = torch.empty(B, HEADS, N, device=DEVICE)
    colsum = torch.empty_like(row0)
    vec = 4 * B * HEADS * N
    names = ("merged heads", "row0", "colsum")
    for label, kw, extra, lib_mask in (
            ("forward", {}, 0, None),
            ("forward, row0 + colsum", dict(row0=row0, colsum=colsum),
             2 * vec, None),
            ("forward, bias, row0 + colsum",
             dict(bias=bias, row0=row0, colsum=colsum), 2 * vec + 4 * B * N,
             float_mask(f32, bias)),
            ("forward, mask, row0 + colsum",
             dict(mask=mask, row0=row0, colsum=colsum), 2 * vec + B * N,
             float_mask(f32, None, mask, mask))):
        def plain(kw=kw):
            return attention_ref(qkv, HEADS, SCALE, kw.get("bias"),
                                 kw.get("mask"))

        want = plain()
        outs = (merged, row0, colsum) if "row0" in kw else (merged,)
        yield ("attention_tf32", label,
               lambda kw=kw: _build.short_attention(qkv, merged, HEADS, SCALE,
                                                    **kw),
               list(zip(names, outs, want)), 4 * B * N * N * D,
               4 * 4 * B * N * D + extra,
               lambda m=lib_mask: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=m, scale=SCALE), plain)


def fp32_bwd_cases(B, N, gen):
    """The same for the fp32 attention backward (short_attention_bwd_tf32_
    kernel) over [B, H, N, hd] operands at B images of N tokens: without
    options, with the branch's row0 cotangent, with ToMe's bias, both
    cotangents and dbias, with a validity mask (fully masked query rows),
    and with the mask, the bias, both cotangents and dbias. The plain
    version is attention_core_train_bwd_ref; the library call SDPA's fp32
    backward alone (autograd) on the same q, k, v and dout, the bias or the
    pair mask as a float mask. flops: the five essential products (S, dP,
    dQ, dK, dV; the kernel recomputes S and dP); bytes: q, k, v, dout in,
    dq, dk, dv out and the vectors each option reads or writes."""
    f32, hd = torch.float32, D // HEADS
    dev_gen = torch.Generator(device=DEVICE).manual_seed(B * 1000 + N + 13)
    q, k, v, dout = torch.randn(4, B, HEADS, N, hd, generator=dev_gen,
                                device=DEVICE).unbind(0)
    drow0, dcs = torch.randn(2, B, HEADS, N, generator=dev_gen,
                             device=DEVICE).unbind(0)
    bias = log_sizes(B, N, gen, f32)
    mask = token_mask(B, N, gen)
    dq, dk, dv = torch.empty(3, B, HEADS, N, hd, device=DEVICE).unbind(0)
    dbias = torch.empty(B, HEADS, N, device=DEVICE)
    vec = 4 * B * HEADS * N
    cot = dict(drow0=drow0, dcs=dcs)
    for label, kw, extra, lib_mask in (
            ("backward", {}, 0, None),
            ("backward, row0 cotangent", dict(drow0=drow0), vec, None),
            ("backward, bias, cotangents, dbias",
             dict(bias=bias, dbias=dbias, **cot), 3 * vec + 4 * B * N,
             float_mask(f32, bias)),
            ("backward, mask", dict(mask=mask), B * N,
             float_mask(f32, None, mask, mask)),
            ("backward, mask, bias, cotangents, dbias",
             dict(mask=mask, bias=bias, dbias=dbias, **cot),
             3 * vec + 5 * B * N, float_mask(f32, bias, mask, mask))):
        def plain(kw=kw):
            return attention_core_train_bwd_ref(
                q, k, v, kw.get("bias"), dout, kw.get("drow0"), kw.get("dcs"),
                SCALE, kw.get("mask"))

        want = plain()
        names, outs = ("dq", "dk", "dv"), (dq, dk, dv)
        if "dbias" in kw:
            names, outs = names + ("dbias",), outs + (dbias,)
        yield ("attention_bwd_tf32", label,
               lambda kw=kw: _build.short_attention_bwd_heads(
                   q, k, v, None, dout, dq, dk, dv, SCALE, **kw),
               list(zip(names, outs, want)), 10 * B * HEADS * N * N * hd,
               7 * 4 * B * HEADS * N * hd + extra,
               sdpa_backward(q, k, v, dout, lib_mask), plain)


# the rectangular fp32 attention at ATS's (M, N) pairs and RECT_WIDE_MN
# (B = 256), and at ATS@0.7's first pair (B = 32)
FP32_RECT = {256: (*RECT_MN, RECT_WIDE_MN), 32: RECT_MN[:1]}


def fp32_rect_cases(B, gen):
    """The same for the fp32 rectangular attention (short_attention_tf32_
    kernel's RECT variant) off a packed qkv at B images and FP32_RECT's
    pairs, each kept-row set with CLS pads and a dead slot (check_rect_rows
    first: pads equal to the CLS slot bit for bit, the dead slot the mean
    of the values). The library call is the kept query rows gathered, then
    SDPA in fp32."""
    for M, N in FP32_RECT[B]:
        dev_gen = torch.Generator(device=DEVICE).manual_seed(M * 1000 + N + B)
        qkv = torch.randn(B, N, 3 * D, generator=dev_gen, device=DEVICE)
        mask = token_mask(B, N, gen)
        idx = kept_ids(B, N, M, mask, gen)
        ids = idx.to(torch.int32)
        merged = torch.empty(B, M, D, device=DEVICE)
        _build.short_attention(qkv, merged, HEADS, SCALE, mask=mask, ids=ids)
        torch.cuda.synchronize()
        tag = f"B={B} M={M} N={N}"
        pads, dead = check_rect_rows(merged, qkv, idx, mask, tag)
        print(f"phase 2 fp32 rect_attention_tf32 {tag}: {pads} padded slots "
              f"equal to CLS, {dead} fully masked rows uniform", flush=True)

        def plain(qkv=qkv, idx=idx, mask=mask):
            return rect_attention_ref(qkv, idx, mask, HEADS, SCALE)

        yield ("rect_attention_tf32", f"forward, mask, {M}x{N}",
               lambda qkv=qkv, merged=merged, mask=mask, ids=ids:
               _build.short_attention(qkv, merged, HEADS, SCALE, mask=mask,
                                      ids=ids),
               [("merged heads", merged, plain())], 4 * B * M * N * D,
               4 * (2 * B * N * D + 2 * B * M * D) + 4 * B * M + B * N,
               lambda qkv=qkv, idx=idx, mask=mask: library_rect(qkv, idx,
                                                                mask),
               plain)


def phase_fp32() -> dict:
    """Phase 2: each fp32 launch of the tensor-core kernels alone at
    FP32_SHAPES (fp32 outputs within 1e-4 of their own max|plain|), with
    its time per launch, the library call's, the 3xTF32 bound (three TF32
    products at the tensor cores' rate, or the bytes) and the FMA bound
    (the products at the fp32 rate outside them, or the bytes); the
    backward's and the rectangular forward's outputs of a second launch
    bit-equal to the first. A rate of three TF32 products above the TF32
    tensor cores' dense peak at the card's highest SM clock fails. Then
    the fp32 backward's GEMM layouts (fp32_bwd_gemm_times). Returns the
    JSON records of gemm_tf32 (qkv), attention_tf32 (the teacher's
    forward), attention_bwd_tf32 (the branch's backward),
    rect_attention_tf32 (138 x 197), gemm_bwd_tf32 (dY . W qkv) and
    gemm_wgrad_tf32 (the qkv weight gradient) at B = 256."""
    gen = torch.Generator().manual_seed(12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ceiling = sms * SM_TF32_FLOP_PER_CLOCK * max_sm_clock_hz()
    print(f"phase 2 fp32: dense TF32 ceiling {ceiling / 1e12:.1f} TFLOP/s "
          f"({sms} SMs at the highest SM clock)", flush=True)
    rec = {}
    record = {"gemm_tf32": "qkv", "attention_tf32": "forward",
              "attention_bwd_tf32": "backward, row0 cotangent",
              "rect_attention_tf32": "forward, mask, 138x197"}
    for B, N in FP32_SHAPES:
        cases = [*fp32_gemm_cases(B, N, gen), *fp32_attention_cases(B, N, gen),
                 *fp32_bwd_cases(B, N, gen), *fp32_rect_cases(B, gen)]
        for launch, label, run, outs, flops, nbytes, library, plain in cases:
            # (the rectangular cases name their (M, N) in the label)
            at = f"B={B}" if launch == "rect_attention_tf32" else \
                f"B={B} N={N}"
            run()
            torch.cuda.synchronize()
            errs, worst = [], 0.0
            for name, got, want in outs:
                abs_err, rel = rel_err(got, want)
                bound_ = LAUNCH_BOUND[torch.float32]
                require(rel <= bound_, f"{launch} {label} {at} {name}: "
                        f"error {rel:.3e} of its max|plain| > bound "
                        f"{bound_:.0e}")
                errs.append(f"{name} {abs_err:.3e} ({rel:.2e} of max)")
                worst = max(worst, abs_err)
            if launch in ("attention_bwd_tf32", "rect_attention_tf32"):
                first = [got.clone() for _, got, _ in outs]
                run()
                torch.cuda.synchronize()
                require(all(torch.equal(a, got) for a, (_, got, _) in
                            zip(first, outs)), f"{launch} {label} {at}: a "
                        "second launch differs from the first")
                errs.append("a second launch bit-equal")
            ms, lib_ms = per_launch_ms(run), per_launch_ms(library)
            library_is = f"library {lib_ms:.4f} ms"
            if launch == "attention_bwd_tf32" and "cotangent" in label:
                # SDPA returns no probabilities, so no cotangent of the CLS
                # row or the column sums enters its backward: no one call
                # computes this function; the eager fp32 composition (the
                # plain version, autograd-free) is timed in its place
                library_is = (f"library none (SDPA takes no row0 or colsum "
                              f"cotangent; without them {lib_ms:.4f} ms), "
                              f"eager fp32 composition "
                              f"{per_launch_ms(plain):.4f} ms")
            t_bytes = nbytes / PEAK_BYTES
            t_tf32, t_fma = 3 * flops / PEAK_TF32_FLOPS, flops / PEAK_FP32_FLOPS
            bound_ms, fma_ms = max(t_tf32, t_bytes) * 1e3, \
                max(t_fma, t_bytes) * 1e3
            bound_by = "operations" if t_tf32 >= t_bytes else "bytes"
            rate = 3 * flops / ms * 1e3
            require(rate <= ceiling, f"{launch} {label} {at}: "
                    f"{rate / 1e12:.1f} TFLOP/s of TF32 is above the ceiling")
            print(f"phase 2 fp32 {launch} {label} {at}: "
                  f"{', '.join(errs)}; kernel {ms:.4f} ms per launch "
                  f"({flops / ms / 1e9:.1f} fp32 TFLOP/s, "
                  f"{rate / 1e12:.1f} of TF32), 3xTF32 bound "
                  f"{bound_ms:.4f} ms ({bound_by}), FMA bound {fma_ms:.4f} "
                  f"ms, {library_is}", flush=True)
            if (B, N) == FP32_SHAPES[0] and launch not in rec and \
                    record[launch] == label:
                rec[launch] = dict(shape=f"fp32 {label} {at}", ms=ms,
                                   plain_ms=per_launch_ms(plain),
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=lib_ms, max_abs_err=worst)
    for B, N in FP32_SHAPES:
        for name, r in fp32_bwd_gemm_times(B, N, gen, ceiling).items():
            if (B, N) == FP32_SHAPES[0]:
                rec[name] = r
    return rec


def fp32_bwd_gemm_times(B, N, gen, ceiling):
    """Phase 2: the fp32 backward's GEMM layouts of a DeiT-S block
    (csrc/gemm_tf32_bwd_sm90.cu, 3xTF32), each launch alone at B x N
    rows: the four dY . W products (W untransposed; fc2's with the GELU'
    factor and the column sums) and the four weight gradients (with their
    bias sums, and the partial sums' launch): each output within 1e-4 of
    its own max|plain| and a second launch's bit-equal to the first, its
    time per launch beside cuBLAS SGEMM's (matmul, matmul(dy.t(), x);
    TF32 off), the 3xTF32 bound and the FMA bound; a rate of three TF32
    products above ``ceiling`` fails. Returns the JSON records of
    gemm_bwd_tf32 (dY . W qkv) and gemm_wgrad_tf32 (the qkv weight
    gradient)."""
    p = block_params(torch.float32, gen)
    dev_gen = torch.Generator(device=DEVICE).manual_seed(B * 1000 + N + 17)
    M = B * N

    def rn(*shape):
        return torch.randn(*shape, generator=dev_gen, device=DEVICE)

    dq, dy, dh, x, h, gp = rn(M, 3 * D), rn(M, D), rn(M, H4), rn(M, D), \
        rn(M, H4), rn(M, H4)
    parts = torch.empty(-(-M // _build.GEMM_TILE), H4, device=DEVICE)
    yd, yh = torch.empty(M, D, device=DEVICE), torch.empty(M, H4,
                                                           device=DEVICE)
    dw = {k: torch.empty_like(p[k]) for k in ("wqkv", "wproj", "w1", "w2",
                                              "bqkv", "bproj", "b2")}

    def wgrad(g, a, w, b=None):
        _build.sum_partials_many(_build.gemm_wgrad(g, a, dw[w],
                                                   None if b is None
                                                   else dw[b]))

    cases = (
        ("dY . W qkv", lambda: _build.gemm(dq, p["wqkv"], None, yd,
                                           w_kn=True),
         [("y", yd, lambda: dq @ p["wqkv"])], lambda: dq @ p["wqkv"],
         dq, D),
        ("dY . W proj", lambda: _build.gemm(dy, p["wproj"], None, yd,
                                            w_kn=True),
         [("y", yd, lambda: dy @ p["wproj"])], lambda: dy @ p["wproj"],
         dy, D),
        ("dY . W fc2, GELU' factor, column sums",
         lambda: _build.gemm(dy, p["w2"], None, yh, w_kn=True, mul=gp,
                             col_sums=parts),
         [("y", yh, lambda: (dy @ p["w2"]) * gp)], lambda: dy @ p["w2"],
         dy, H4),
        ("dY . W fc1", lambda: _build.gemm(dh, p["w1"], None, yd, w_kn=True),
         [("y", yd, lambda: dh @ p["w1"])], lambda: dh @ p["w1"], dh, D),
        ("weight gradient qkv", lambda: wgrad(dq, x, "wqkv", "bqkv"),
         [("dw", dw["wqkv"], lambda: dq.t() @ x),
          ("db", dw["bqkv"], lambda: dq.sum(0))], lambda: dq.t() @ x,
         dq, D),
        ("weight gradient proj", lambda: wgrad(dy, x, "wproj", "bproj"),
         [("dw", dw["wproj"], lambda: dy.t() @ x),
          ("db", dw["bproj"], lambda: dy.sum(0))], lambda: dy.t() @ x,
         dy, D),
        ("weight gradient fc1", lambda: wgrad(dh, x, "w1"),
         [("dw", dw["w1"], lambda: dh.t() @ x)], lambda: dh.t() @ x, dh, D),
        ("weight gradient fc2", lambda: wgrad(dy, h, "w2", "b2"),
         [("dw", dw["w2"], lambda: dy.t() @ h),
          ("db", dw["b2"], lambda: dy.sum(0))], lambda: dy.t() @ h, dy, H4))
    rec, record = {}, {"dY . W qkv": "gemm_bwd_tf32",
                       "weight gradient qkv": "gemm_wgrad_tf32"}
    for label, run, outs, library, g, K in cases:
        launch = "gemm_wgrad_tf32" if label.startswith("weight") \
            else "gemm_bwd_tf32"
        run()
        torch.cuda.synchronize()
        errs, worst, wants = [], 0.0, [want() for _, _, want in outs]
        for (name, got, _), want in zip(outs, wants):
            abs_err, rel = rel_err(got, want)
            require(rel <= LAUNCH_BOUND[torch.float32], f"{launch} {label} "
                    f"B={B} N={N} {name}: error {rel:.3e} of its max|plain|")
            errs.append(f"{name} {abs_err:.3e} ({rel:.2e} of max)")
            worst = max(worst, abs_err)
        first = [got.clone() for _, got, _ in outs]
        run()
        torch.cuda.synchronize()
        require(all(torch.equal(a, got) for a, (_, got, _) in
                    zip(first, outs)), f"{launch} {label} B={B} N={N}: a "
                "second launch differs from the first")
        errs.append("a second launch bit-equal")
        flops = 2 * M * g.shape[1] * K
        outs_bytes = sum(4 * got.numel() for _, got, _ in outs)
        nbytes = 4 * (g.numel() + M * K if label.startswith("weight")
                      else g.numel() + g.shape[1] * K) + outs_bytes + (
            4 * (gp.numel() + parts.numel()) if "GELU'" in label else 0)
        ms, lib_ms = per_launch_ms(run), per_launch_ms(library)
        t_bytes = nbytes / PEAK_BYTES
        t_tf32 = 3 * flops / PEAK_TF32_FLOPS
        bound_ms = max(t_tf32, t_bytes) * 1e3
        fma_ms = max(flops / PEAK_FP32_FLOPS, t_bytes) * 1e3
        rate = 3 * flops / ms * 1e3
        require(rate <= ceiling, f"{launch} {label} B={B} N={N}: "
                f"{rate / 1e12:.1f} TFLOP/s of TF32 is above the ceiling")
        print(f"phase 2 fp32 {launch} {label} B={B} N={N}: {', '.join(errs)}"
              f"; kernel {ms:.4f} ms per launch ({flops / ms / 1e9:.1f} fp32 "
              f"TFLOP/s, {rate / 1e12:.1f} of TF32), 3xTF32 bound "
              f"{bound_ms:.4f} ms, FMA bound {fma_ms:.4f} ms, cuBLAS SGEMM "
              f"{lib_ms:.4f} ms", flush=True)
        if label in record:
            rec[record[label]] = dict(
                shape=f"fp32 {label} B={B} N={N}", ms=ms,
                plain_ms=per_launch_ms(lambda: [want() for _, _, want in
                                                outs]),
                bound_ms=bound_ms,
                bound_by="operations" if t_tf32 >= t_bytes else "bytes",
                library_ms=lib_ms, max_abs_err=worst)
    return rec


# the LayerNorm backward's launches alone (csrc/ln_gemm.cu): B = 256 at
# the training widths, B = 32 at N = 197 (M = 6304: a ragged last band),
# each in bf16 and fp32 at DeiT-S's K = 384, and the general instance at
# DeiT-Ti's K = 192
LN_BWD_SHAPES = tuple((256, n, D) for n in TRAIN_N) + ((32, 197, D),
                                                       (32, 197, 192))


def ln_bwd_inputs(M, K, dtype, gen):
    """x [M, K], gamma and beta [K] in dtype, and the fp32 dLN [M, K]."""
    def rn(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=gen)).to(
            DEVICE)

    return (rn(M, K).to(dtype), rn(K, scale=0.1, shift=1.0).to(dtype),
            rn(K, scale=0.1).to(dtype), rn(M, K))


def library_ln_bwd(x, w, b, dln):
    """The one PyTorch call that computes the LayerNorm backward:
    aten.native_layer_norm_backward on the same x, the forward's mean and
    rstd (from aten.native_layer_norm), and dLN cast once, outside the
    call, to x's dtype (the call takes the output gradient in the input's
    dtype)."""
    K = x.shape[1]
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [K], w, b, EPS)
    dy = dln.to(x.dtype)
    return lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [K], mean, rstd, w, b, [True, True, True])


def phase_ln_bwd() -> dict:
    """Phase 2: each layer_norm_bwd launch alone at LN_BWD_SHAPES against
    its fp32 plain version: dx within 1e-2 of its own max in bf16 and 1e-4
    in fp32, d gamma and d beta (rounded to the parameters' dtype) within
    1e-2 and 1e-4 of theirs; a second launch must give the same bits. Then
    its time per launch beside its bound (bytes: x, dLN and gamma read
    once, dx and the two gradients written once), the plain version's time
    and aten.native_layer_norm_backward's. Returns the JSON record of the
    bf16 launch at B = 256, N = 197."""
    gen = torch.Generator().manual_seed(7)
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for B, N, K in LN_BWD_SHAPES:
            M, shape = B * N, f"B={B} N={N} K={K}"
            x, w, b, dln = ln_bwd_inputs(M, K, dtype, gen)
            dx, dwb = torch.empty_like(x), torch.empty(2, K, device=DEVICE,
                                                       dtype=dtype)

            def run():
                _build.sum_partials_many(
                    _build.layer_norm_bwd(x, w, dln, dx, dwb, eps=EPS))

            def plain():
                x_hat, rstd = layer_norm_stats(x.float(), EPS)
                return layer_norm_bwd_ref(dln, x_hat, rstd, w)

            run()
            first = dx.clone(), dwb.clone()
            run()
            torch.cuda.synchronize()
            require(torch.equal(first[0], dx) and torch.equal(first[1], dwb),
                    f"layer_norm_bwd {tag} {shape}: two launches differ")
            errs, worst = [], 0.0
            for label, got, want in zip(("dx", "d scale", "d bias"),
                                        (dx, dwb[0], dwb[1]), plain()):
                abs_err, rel = rel_err(got, want.to(dtype))
                bound_ = LAUNCH_BOUND[dtype]
                require(rel <= bound_, f"layer_norm_bwd {tag} {shape} "
                        f"{label}: error {rel:.3e} of its max|plain| > "
                        f"bound {bound_:.0e}")
                errs.append(f"{label} {abs_err:.3e} ({rel:.2e} of max, "
                            f"bound {bound_:.0e})")
                worst = max(worst, abs_err)
            E = x.element_size()
            nbytes = M * K * (2 * E + 4) + 3 * K * E
            bound_ms = nbytes / PEAK_BYTES * 1e3
            ms, lib_ms = per_launch_ms(run), per_launch_ms(
                library_ln_bwd(x, w, b, dln))
            plain_ms = per_launch_ms(plain)
            print(f"phase 2 layer_norm_bwd {tag} {shape}: {', '.join(errs)};"
                  f" two launches bit-equal; kernel {ms:.4f} ms per launch, "
                  f"bound {bound_ms:.4f} ms (bytes), plain {plain_ms:.4f} "
                  f"ms, library {lib_ms:.4f} ms", flush=True)
            if not rec and dtype == torch.bfloat16:
                rec = dict(shape=f"bf16 {shape}", ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by="bytes",
                           library_ms=lib_ms, max_abs_err=worst)
    return rec


def wgrad_shapes():
    """(label, [splits, L] of the fp32 partials) that gemm_wgrad sums at
    B = 256, N = 197: each weight's, then each bias's."""
    M, out = 256 * 197, []
    for label, n_out, K in (("qkv", 3 * D, D), ("proj", D, D),
                            ("fc1", H4, D), ("fc2", D, H4)):
        splits = _build.wgrad_plan(M, n_out, K, torch.device(DEVICE))[0]
        out += [(f"dW {label}", (splits, n_out * K)),
                (f"db {label}", (splits, n_out))]
    return out


def standalone_cases():
    """(kernel, shape, make the timed call, nbytes, make the library call or
    None) for the other hand-written kernels of the main path, at B = 256
    (their time per launch, bound and library call; the LayerNorm backward
    and the rectangular attention have their own cases above): layer_norm
    of bf16, fp32 and gathered rows (the library call F.layer_norm on the
    same rows, with the parameters in the rows' type; on fp32 rows it
    writes fp32 where the kernel writes bf16; gathered rows have no one
    call), sum_partials at the LayerNorm
    backward's [bands, 2K] and its former [264, 2K] (two blocks an SM) and
    at gemm_wgrad's [splits, L] (bf16 out), head_mean_keys at ToMe@0.7's
    widths. Each make returns a call on its own copies of the inputs
    (``cold``)."""
    gen = torch.Generator().manual_seed(8)
    bf16, B = torch.bfloat16, 256

    def rn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen).to(DEVICE, dtype)

    w, b = rn(D), rn(D)
    M = B * 197
    for label, x in (("bf16 rows", rn(M, D)),
                     ("fp32 rows", rn(M, D, dtype=torch.float32))):
        yield ("layer_norm", f"{label} B={B} N=197",
               lambda x=x: functools.partial(
                   _build.layer_norm, x.clone(), w, b,
                   torch.empty(M, D, device=DEVICE, dtype=bf16), eps=EPS),
               M * D * (x.element_size() + 2) + 4 * D,
               lambda x=x: functools.partial(F.layer_norm, x.clone(), (D,),
                                             w.to(x.dtype), b.to(x.dtype),
                                             EPS))
    N, K = 197, 138
    x = rn(B * N, D)
    idx = torch.stack([torch.randperm(N, generator=gen)[:K]
                       for _ in range(B)]).to(DEVICE, torch.int32)
    yield ("layer_norm", f"gathered rows B={B} N={N} K={K}",
           lambda: functools.partial(
               _build.layer_norm, x.clone(), w, b,
               torch.empty(B * K, D, device=DEVICE, dtype=bf16), eps=EPS,
               idx=idx.clone(), rows_out=K, rows_in=N),
           B * K * (2 * D * 2 + 4) + 4 * D, None)
    ln_bands = _build.ln_bwd_plan(M, torch.cuda.get_device_properties(
        0).multi_processor_count)[0]
    for label, (S, L) in (("layer_norm_bwd's former", (264, 2 * D)),
                          ("layer_norm_bwd's", (ln_bands, 2 * D)),
                          *wgrad_shapes()):
        part = rn(S, L, dtype=torch.float32)
        yield ("sum_partials", f"{label} [{S}, {L}]",
               lambda part=part, L=L: functools.partial(
                   _build.sum_partials, part.clone(),
                   torch.empty(L, device=DEVICE, dtype=bf16)),
               S * L * 4 + L * 2,
               lambda part=part: functools.partial(torch.sum, part.clone(),
                                                   0))
    hd = D // HEADS
    for N in TOME_N:
        qkv = rn(B, N, 3 * D)
        yield ("head_mean_keys", f"B={B} N={N}",
               lambda qkv=qkv, N=N: functools.partial(
                   _build.head_mean_keys, qkv.clone(),
                   torch.empty(B, N, hd, device=DEVICE, dtype=bf16), HEADS),
               B * N * (D + hd) * 2,
               lambda qkv=qkv: functools.partial(library_keys, qkv.clone()))


def library_keys(qkv):
    """The head mean of the packed keys in one PyTorch call (DeiT-S)."""
    B, N, _ = qkv.shape
    return qkv[..., D:2 * D].view(B, N, HEADS, D // HEADS).mean(2)


def phase_standalone() -> list:
    """Phase 2: each of standalone_cases' launches alone, its time per
    launch (over cold copies of its inputs) beside its bound (bytes at the
    H100's rate) and its library call's; returns [(kernel, shape, ms,
    bound ms, library ms or None)] for the table printed with the main
    path's launches (main)."""
    rows = []
    for name, shape, make, nbytes, make_library in standalone_cases():
        ms = per_launch_ms(cold(make, nbytes))
        lib_ms = per_launch_ms(cold(make_library, nbytes)) \
            if make_library else None
        bound_ms = nbytes / PEAK_BYTES * 1e3
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"phase 2 standalone {name} {shape}: kernel {ms:.4f} ms per "
              f"launch, bound {bound_ms:.4f} ms (bytes), library {lib}",
              flush=True)
        rows.append((name, shape, ms, bound_ms, lib_ms))
    return rows


def device_ms(fn, calls: int = 10) -> float | None:
    """The card's time per call of fn from torch.profiler: the device time
    of every kernel that ``calls`` back-to-back calls launch, over calls
    (None when the profiler saw no device events). Below about 0.04 ms
    the event time of per_launch_ms is the host's launch cost; this is
    not."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3 if us > 0 else None


COLD_COPIES = 256  # at most, so inputs under about 0.4 MB stay in the L2


def cold(make, nbytes: int):
    """A call that runs make()'s calls in turn, each on its own copies of
    the inputs (make returns a call with fresh copies): so many that the
    calls between two uses of one copy touch twice the card's L2 (50 MB on
    the H100), and a timed call reads its nbytes from HBM, as its bound
    counts them, not from the L2 that its previous call filled. At most
    COLD_COPIES copies: the smallest sums stay in the L2, where a launch
    costs far more than its bound."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    copies = min(COLD_COPIES, 1 + -(-2 * l2 // max(1, nbytes)))
    calls = itertools.cycle([make() for _ in range(copies)])
    return lambda: next(calls)()


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_keys() -> dict:
    """Phase 2: head_mean_keys (csrc/short_attention.cu) at every ToMe@0.7
    width, B = 256 and B = 32, bf16 and fp32, bit-equal to
    head_mean_keys_ref (fp32 head-order sum, one true division, one
    rounding); at B = 256 its time per launch (events and torch.profiler,
    over cold copies of qkv) beside its bound (bytes: the keys read once,
    the mean written once), the plain version's and the head mean of the
    packed keys in one PyTorch call. Returns the JSON record of bf16
    B = 256, N = 197."""
    gen = torch.Generator().manual_seed(9)
    rec, hd = {}, D // HEADS
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for B, N in [(B, N) for B in (256, 32) for N in TOME_N]:
            shape = f"B={B} N={N} D={D} H={HEADS}"
            qkv = torch.randn(B, N, 3 * D, generator=gen).to(DEVICE, dtype)
            keys = torch.empty(B, N, hd, device=DEVICE, dtype=dtype)
            _build.head_mean_keys(qkv, keys, HEADS)
            want = head_mean_keys_ref(qkv, HEADS)
            torch.cuda.synchronize()
            diff = (keys.float() - want.float()).abs().max().item()
            require(torch.equal(keys, want), f"head_mean_keys {tag} {shape}"
                    f": not bit-equal to head_mean_keys_ref (max abs "
                    f"difference {diff:.3e})")
            if B != 256:
                print(f"phase 2 keys head_mean_keys {tag} {shape}: "
                      "bit-equal to head_mean_keys_ref", flush=True)
                continue
            nbytes = B * N * (D + hd) * qkv.element_size()
            bound_ms = nbytes / PEAK_BYTES * 1e3
            run = cold(lambda qkv=qkv, keys=keys: functools.partial(
                _build.head_mean_keys, qkv.clone(), torch.empty_like(keys),
                HEADS), nbytes)
            plain = cold(lambda qkv=qkv: functools.partial(
                head_mean_keys_ref, qkv.clone(), HEADS), nbytes)
            library = cold(lambda qkv=qkv: functools.partial(
                library_keys, qkv.clone()), nbytes)
            ms, dev_ms = per_launch_ms(run), device_ms(run)
            plain_ms, lib_ms = per_launch_ms(plain), per_launch_ms(library)
            print(f"phase 2 keys head_mean_keys {tag} {shape}: bit-equal to "
                  f"head_mean_keys_ref; kernel {ms:.4f} ms per launch "
                  f"(events), {fmt_ms(dev_ms)} (device, torch.profiler), "
                  f"bound {bound_ms:.4f} ms (bytes), plain {plain_ms:.4f} "
                  f"ms, library {lib_ms:.4f} ms (cold copies)", flush=True)
            if not rec:
                rec = dict(shape=f"{tag} {shape}", max_abs_err=diff, ms=ms,
                           device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by="bytes",
                           library_ms=lib_ms)
    return rec


def branch_sums(B, N, gen) -> dict:
    """{branch: [(partials, out)]}: the pairs that the bf16 attention and
    MLP branch backwards hand to their one sum launch at B, N (DeiT-S),
    recorded from one backward of each with real partials."""
    bf16 = torch.bfloat16
    p = block_params(bf16, gen)

    def rn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen).to(DEVICE, dtype)

    x, dy = rn(B, N, D), rn(B, N, D)
    drow0 = rn(B, HEADS, N, dtype=torch.float32)
    recorded, real = [], _build.sum_partials_many
    _build.sum_partials_many = recorded.append
    try:
        saved = fused_block_train._fwd_cuda(
            x, *(p[k] for k in ATTN), HEADS, SCALE, EPS)[2]
        fused_block_train._bwd_cuda(x, p["ls1"], p["wqkv"], p["wproj"],
                                    saved, dy, drow0, HEADS, SCALE, EPS)
        saved = fused_mlp_train._fwd_cuda(x, *(p[k] for k in MLP), EPS)[1]
        fused_mlp_train._bwd_cuda(x, p["ls2"], p["w1"], p["w2"], saved, dy,
                                  EPS)
    finally:
        _build.sum_partials_many = real
    require(len(recorded) == 2 and all(len(r) == 5 for r in recorded),
            f"branch backwards' sum launches: {[len(r) for r in recorded]}")
    return dict(zip(("attention", "mlp"), recorded))


def sum_sets():
    """(label, [(partials, out)]) for phase_sums: each branch's job set at
    B = 256 and N = 197 and at topk@0.7's narrowest stage (N = 68), a set
    of eight jobs (fp32 and bf16 outs, one and 394 rows, a width that is
    no multiple of 4), a job of such a width alone, and nine jobs (two
    launches, split in order)."""
    gen = torch.Generator().manual_seed(10)
    for N in (197, 68):
        for branch, pairs in branch_sums(256, N, gen).items():
            yield f"{branch} branch B=256 N={N}", pairs

    def job(S, L, dtype=torch.bfloat16):
        return (torch.randn(S, L, generator=gen).to(DEVICE),
                torch.empty(L, device=DEVICE, dtype=dtype))

    eight = [job(7, 1152), job(132, 768, torch.float32), job(1, 4),
             job(394, 1536), job(22, 147456), job(9, 1001),
             job(5, 10, torch.float32), job(3, 589824)]
    yield "eight jobs", eight
    yield "one job of width 1001", [job(9, 1001)]
    yield "nine jobs", eight + [job(13, 333, torch.float32)]


def plain_sum(part, out_dtype):
    """The plain version: fp32 rows added in z order from 0, rounded once."""
    acc = torch.zeros(part.shape[1], device=part.device)
    for row in part:
        acc = acc + row
    return acc.to(out_dtype)


def plain_sums(pairs):
    return [plain_sum(part, out.dtype) for part, out in pairs]


def single_sums(pairs):
    """One single-job launch a pair."""
    for pair in pairs:
        _build.sum_partials(*pair)


def library_sums(pairs):
    """One part.sum(0) a pair: no one PyTorch call computes a set."""
    return [part.sum(0) for part, _ in pairs]


def phase_sums() -> dict:
    """Phase 2: sum_partials_many (csrc/ln_gemm.cu) on each of sum_sets'
    job sets, bit-equal to one single-job sum_partials launch per job and
    to the plain z-order sum, in the launches sum_order gives; its time
    per launch (events and torch.profiler, over cold copies of the pairs)
    beside its bound (bytes: the partials read once, the outputs written
    once), the single launches' and the part.sum(0) calls' (one a job: no
    one PyTorch call computes a set). Returns the JSON record of the
    attention branch's set at B = 256, N = 197."""
    rec = {}
    for label, pairs in sum_sets():
        outs = [o for _, o in pairs]
        launches = len(_build.sum_order([tuple(p.shape) for p, _ in pairs]))
        before = _build.sum_partials_many.launches
        _build.sum_partials_many(pairs)
        require(_build.sum_partials_many.launches - before == launches,
                f"sums {label}: {_build.sum_partials_many.launches - before}"
                f" launches, the plan's {launches}")
        batched = [o.clone() for o in outs]
        single_sums(pairs)
        single = [o.clone() for o in outs]
        plain = plain_sums(pairs)
        torch.cuda.synchronize()
        err = 0.0
        for i, (b, s1, pl) in enumerate(zip(batched, single, plain)):
            shape = tuple(pairs[i][0].shape)
            require(torch.equal(b, s1), f"sums {label} job {i} {shape}: the "
                    "batched launch and the single one differ")
            require(torch.equal(b, pl), f"sums {label} job {i} {shape}: not "
                    "bit-equal to the plain z-order sum")
            err = max(err, (b.float() - pl.float()).abs().max().item())

        nbytes = sum(p.numel() * 4 + o.numel() * o.element_size()
                     for p, o in pairs)

        def timed(fn, pairs=pairs, nbytes=nbytes):
            """fn over cold copies of the pairs."""
            return cold(lambda: functools.partial(fn, [
                (p.clone(), torch.empty_like(o)) for p, o in pairs]), nbytes)

        bound_ms = nbytes / PEAK_BYTES * 1e3
        run, run_single = timed(_build.sum_partials_many), timed(single_sums)
        library = timed(library_sums)
        ms, dev_ms = per_launch_ms(run), device_ms(run)
        single_ms, single_dev = per_launch_ms(run_single), \
            device_ms(run_single)
        lib_ms, lib_dev = per_launch_ms(library), device_ms(library)
        shapes = " ".join(f"[{p.shape[0]}, {p.shape[1]}]" for p, _ in pairs)
        print(f"phase 2 sums {label} ({len(pairs)} jobs {shapes}): "
              f"{launches} launch(es) bit-equal to {len(pairs)} single "
              f"launches and to the plain sum; batched {ms:.4f} ms "
              f"(events), {fmt_ms(dev_ms)} (device); single launches "
              f"{single_ms:.4f} ms, {fmt_ms(single_dev)} (device); "
              f"part.sum(0) calls {lib_ms:.4f} ms, {fmt_ms(lib_dev)} "
              f"(device); bound {bound_ms:.4f} ms (bytes); cold copies",
              flush=True)
        if not rec:
            plain_ms = per_launch_ms(timed(plain_sums))
            rec = dict(shape=f"{label}, {shapes}", max_abs_err=err, ms=ms,
                       device_ms=dev_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                       library_calls_ms=lib_ms, library_calls=len(pairs),
                       single_launches_ms=single_ms,
                       single_launches_device_ms=single_dev)
    return rec


def layer_norm_record() -> dict:
    """The JSON record of layer_norm (csrc/ln_gemm.cu): bf16 rows at
    B = 256, N = 197 against the plain fp32 LayerNorm rounded to bf16
    (within 1e-2 of its max), its time per launch (over cold copies of x)
    beside its bound (bytes: x read once, y written once, the parameters),
    the plain version's and F.layer_norm's."""
    gen = torch.Generator().manual_seed(11)
    bf16, M = torch.bfloat16, 256 * 197
    x, w, b = (torch.randn(*shape, generator=gen).to(DEVICE, bf16)
               for shape in ((M, D), (D,), (D,)))
    y = torch.empty_like(x)
    _build.layer_norm(x, w, b, y, eps=EPS)
    abs_err, rel = rel_err(y, layer_norm_f32(x.float(), w, b, EPS).to(bf16))
    require(rel <= LAUNCH_BOUND[bf16], f"layer_norm bf16 rows: error "
            f"{rel:.3e} of its max|plain|")
    nbytes = M * D * 4 + 4 * D
    run = cold(lambda: functools.partial(
        _build.layer_norm, x.clone(), w, b, torch.empty_like(y), eps=EPS),
        nbytes)
    plain = cold(lambda: lambda x=x.clone(): layer_norm_f32(
        x.float(), w, b, EPS).to(bf16), nbytes)
    library = cold(lambda: functools.partial(F.layer_norm, x.clone(), (D,),
                                             w, b, EPS), nbytes)
    return dict(shape=f"bf16 rows B=256 N=197 K={D}", max_abs_err=abs_err,
                ms=per_launch_ms(run), device_ms=device_ms(run),
                plain_ms=per_launch_ms(plain),
                bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                library_ms=per_launch_ms(library))


def check_case(name, tag, shape, dtype, got, want, labels, rec):
    require(len(got) == len(want) <= len(labels),
            f"{name} {tag} {shape}: {len(got)} outputs, plain {len(want)}")
    errs = []
    for label, g, w in zip(labels, got, want):
        abs_err, rel = rel_err(g, w)
        require(rel <= BOUND[dtype], f"{name} {tag} {shape} {label}: error "
                f"{rel:.3e} of max|plain| > bound {BOUND[dtype]:.0e}")
        errs.append(f"{label} {abs_err:.3e} ({rel:.2e} rel)")
        rec[f"max_rel_err_{tag}"] = max(rec[f"max_rel_err_{tag}"], rel)
        if label in ("out", "branch") and dtype == torch.bfloat16:
            rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    return errs


def phase_kernels() -> dict:
    """Phase 2. Returns per-kernel records for the JSON line (and
    fused_attention's)."""
    gen = torch.Generator().manual_seed(0)
    rec = {name: dict(max_abs_err=0.0, max_rel_err_fp32=0.0,
                      max_rel_err_bf16=0.0) for name in WRAPPERS}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        cases = [(n, s, k, p, lib, ("out", "row0", "colsum", "keys"))
                 for n, s, k, p, lib in kernel_cases(dtype, gen)]
        cases += [(n, s, k, p, lib, GRAD_NAMES[n])
                  for n, s, k, p, lib in train_cases(dtype, gen)]
        for name, shape, kernel, plain, library, labels in cases:
            got, want = as_list(kernel()), as_list(plain())
            torch.cuda.synchronize()
            errs = check_case(name, tag, shape, dtype, got, want, labels,
                              rec[name])
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            lib = ""
            if "teacher" in shape:
                teacher_ms, teacher_by = bound(name, TRAIN_B, 197,
                                               dtype=dtype)
                fma_ms, fma_by = bound(name, TRAIN_B, 197, dtype=dtype,
                                       fma=True)
                lib = (f", bound {teacher_ms:.4f} ms ({teacher_by}, "
                       f"3xTF32), FMA bound {fma_ms:.4f} ms ({fma_by}), "
                       f"library {cuda_ms(library):.4f} ms (the eager fp32 "
                       "composition: F.layer_norm, F.linear, SDPA, F.gelu; "
                       "TF32 off)")
            if dtype == torch.bfloat16:
                lib_ms = cuda_ms(library)
                dims = [int(part.split("=")[1]) for part in shape.split()
                        if "=" in part]
                bound_ms, bound_by = bound(name, *dims,
                                           masked="mask" in shape)
                lib = (f", library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                       f"({bound_by})")
            print(f"phase 2 kernel {name} {tag} {shape}: max abs err "
                  f"{', '.join(errs)}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms{lib}", flush=True)
            if dtype == torch.bfloat16 and "shape" not in rec[name]:
                # the widest main-path shape stands for the kernel
                rec[name].update(shape=f"bf16 {shape}", ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by,
                                 library_composition_ms=lib_ms)
    return rec


def settle():
    """Before a timed run: collect the garbage the checks left behind
    (cycles hold models and their optimizer states) and return the
    allocator's cached blocks, so that no run pays for the one before."""
    gc.collect()
    torch.cuda.empty_cache()


def images(B, gen, dtype=torch.float32):
    return torch.randn(B, 3, 224, 224, generator=gen).to(DEVICE, dtype)


REDUCING = ("topk", "tome", "ats", "heuristic", "dyvit", "evit", "kmedoids",
            "dpcknn", "sinkhorn", "patchmerger", "sit")
# an input wider than the fused full block and the single-pass attention
# take: 272 px, N = 290 tokens
WIDE_IMG = 272


def record_decisions(model) -> dict:
    """Record the decisions of the model's next forwards, without viz mode
    (so every block runs its kernels), in viz mode's keys: topk's and
    DyViT's Kept_Tokens (patch-local ids of each reduction block, from the
    ids its MLP gathers or its attention keeps), ATS's (its sample ids,
    -1 for a pad), ToMe's Assignment_Maps (from each matching, with the
    width after the merge under "widths"), heuristic's Kept_Tokens_Abs
    (the static masks' kept patches); EViT's Kept_Tokens (with the fused
    token's -1) and Fusion_Assign, from the ids its MLP gathers;
    k-medoids' and DPC-KNN's Kept_Tokens (medoids, centres) and
    Assignment_Maps, SiT's, PatchMerger's and Sinkhorn's Assignment_Maps
    (the argmax of each soft assignment over the centres, and the soft
    assignments), from their clustering's outputs. k-medoids' and
    DPC-KNN's model on the CPU takes the card's ids (record_clustering)."""
    c = model.cfg
    rec = {}
    if c.method == "evit":
        kept = rec.setdefault("Kept_Tokens", {})
        fusion = rec.setdefault("Fusion_Assign", {})
        for i in c.reduction_loc:
            blk = model.blocks[i]

            def gather(x, idx, generator=None, i=i, inner=blk.ffn_gather):
                ids = idx[:, 1:-1] - 1
                kept[i] = torch.cat([ids, torch.full_like(ids[:, :1], -1)], 1)
                # x holds the N tokens and the fused row
                fusion[i] = complement_idx(ids, x.shape[1] - 2)
                return inner(x, idx, generator)

            blk.ffn_gather = gather
    elif c.method in ("kmedoids", "dpcknn"):
        # filled by record_clustering, by the device the clustering ran on
        rec.update(Kept_Tokens={}, Assignment_Maps={}, calls=[0])
        CLUSTERED[next(model.parameters()).device.type] = (
            rec, list(c.reduction_loc))
    elif c.method in ("sinkhorn", "patchmerger", "sit"):
        maps = rec.setdefault("Assignment_Maps", {})
        soft = rec.setdefault("Soft_Assignment_Maps", {})
        for i, layer in zip(c.reduction_loc, model.cluster_layers):
            def clustered(mod, args, out, i=i):
                soft[i] = out[1]
                maps[i] = out[1].argmax(-2)

            layer.register_forward_hook(clustered)
    elif c.method == "topk":
        kept = rec.setdefault("Kept_Tokens", {})
        for i in c.reduction_loc:
            blk = model.blocks[i]

            def gather(x, idx, generator=None, i=i, inner=blk.ffn_gather):
                kept[i] = idx[:, 1:] - 1
                return inner(x, idx, generator)

            blk.ffn_gather = gather
    elif c.method == "dyvit":
        kept = rec.setdefault("Kept_Tokens", {})
        for i in c.reduction_loc:
            blk = model.blocks[i]

            def attend(x, *, idx=None, i=i, inner=blk.attend, **kw):
                kept[i] = idx[:, 1:] - 1
                return inner(x, idx=idx, **kw)

            blk.attend = attend
    elif c.method == "ats":
        kept = rec.setdefault("Kept_Tokens", {})
        for i, blk in enumerate(model.blocks):
            def sampled(mod, args, out, i=i):
                if out[2] is not None:
                    kept[i] = out[2][:, 1:] - 1

            blk.register_forward_hook(sampled)
    elif c.method == "heuristic":
        rec["Kept_Tokens_Abs"] = {i: getattr(model, f"kept_{i}")
                                  for i in model.active_loc}
    elif c.method == "tome":
        # filled by recorded_assignment, by the device the matching ran on
        rec.update(Assignment_Maps={}, widths=[])
        ASSIGNMENTS[next(model.parameters()).device.type] = (
            rec, list(c.reduction_loc))
    return rec


ASSIGNMENTS = {}  # device type -> (ToMe's record, its merge blocks)
# k-medoids' and DPC-KNN's clustering: device type -> (the model's
# record, its reduction blocks)
CLUSTERED = {}
KMEDOIDS_FIT = cluster_model.k_medoids_fit
DPC_KNN = cluster_model.cluster_dpc_knn


def record_clustering(x, **decisions):
    """Record one clustering's ids (Kept_Tokens, Assignment_Maps) in the
    record of the device it ran on, by reduction block. On the CPU, return
    the card's ids of the same block, which the CPU model then takes (as
    DyViT's share_scores): with random weights the clustering's scores
    tie within the two devices' fp32 roundings in a few places, and a
    flipped id would change the tokens every later block sees. Else
    None."""
    dev = x.device.type
    if dev not in CLUSTERED:
        return None
    rec, blocks = CLUSTERED[dev]
    i = blocks[rec["calls"][0] % len(blocks)]
    rec["calls"][0] += 1
    for key, ids in decisions.items():
        rec[key][i] = ids.detach().cpu()
    card = CLUSTERED.get("cuda")
    if dev == "cpu" and card is not None and i in card[0]["Kept_Tokens"]:
        return {key: card[0][key][i] for key in decisions}
    return None


def recorded_kmedoids(x, *args, **kw):
    """k-medoids' fit, recorded (record_clustering); on the CPU the card's
    medoids, gathered from the CPU's tokens, and assignments."""
    centers, idx, assignment = KMEDOIDS_FIT(x, *args, **kw)
    card = record_clustering(x, Kept_Tokens=idx, Assignment_Maps=assignment)
    if card is not None:
        idx, assignment = card["Kept_Tokens"], card["Assignment_Maps"]
        centers = take_tokens(x, idx)
    return centers, idx, assignment


def recorded_dpc_knn(x, *args, **kw):
    """DPC-KNN's clustering, recorded (record_clustering); on the CPU the
    card's ids."""
    idx_cluster, index_down = DPC_KNN(x, *args, **kw)
    card = record_clustering(x, Assignment_Maps=idx_cluster,
                             Kept_Tokens=index_down)
    if card is not None:
        idx_cluster, index_down = card["Assignment_Maps"], card["Kept_Tokens"]
    return idx_cluster, index_down


def record_clusterings(on: bool):
    """Route k-medoids' and DPC-KNN's clustering through the recorders
    (on) or back to their own functions (off, the records dropped)."""
    cluster_model.k_medoids_fit = recorded_kmedoids if on else KMEDOIDS_FIT
    cluster_model.cluster_dpc_knn = recorded_dpc_knn if on else DPC_KNN
    if not on:
        CLUSTERED.clear()


def recorded_assignment(metric, r, **kw):
    """ToMe's matching, recording each merge's Assignment_Maps entry and
    the width after it in the record of the device it ran on."""
    info = MATCHING(metric, r, **kw)
    rec, blocks = ASSIGNMENTS[metric.device.type]
    merge = len(rec["widths"])
    rec["Assignment_Maps"][blocks[merge]] = tome_model.merge_source_assignment(
        info)
    rec["widths"].append(info.t - info.r)
    return info


def phase_models(dtype):
    """Phase 3: the full-width models on the card against the CPU, their
    decisions recorded through hooks with viz mode off; then, in fp32,
    each reducing model in viz mode (its blocks pinned to the plain
    composition: no kernel may launch), and a dense model on a 272-pixel
    input, N = 290 (the wide attention kernels: wider than the
    single-pass ones)."""
    tag = "fp32" if dtype == torch.float32 else "bf16"
    B, bound_ = MODEL_BATCH[dtype], MODEL_BOUND[dtype]
    tome_model.bipartite_soft_matching = recorded_assignment
    record_clusterings(True)
    try:
        for label, (name, kw) in MODELS.items():
            model_check(label, name, kw, dtype, tag, B, bound_)
    finally:
        tome_model.bipartite_soft_matching = MATCHING
        record_clusterings(False)
        ASSIGNMENTS.clear()
    if dtype == torch.float32:
        for label, (name, kw) in MODELS.items():
            if name.split("_")[0] in REDUCING:
                viz_check(label, name, kw, B)
        wide_check(B, bound_)


def model_check(label, name, kw, dtype, tag, B, bound_):
    """One model's phase 3 eval check (see phase_models)."""
    model, cfg = create_model(name, device=DEVICE,
                              generator=torch.Generator().manual_seed(1),
                              **kw)
    model = model.to(dtype).eval()
    cpu_model = copy.deepcopy(model).cpu()
    if cfg.method == "dyvit" and dtype == torch.bfloat16:
        share_scores(model, cpu_model)
    v, v_ref = record_decisions(model), record_decisions(cpu_model)
    x = images(B, torch.Generator().manual_seed(2), dtype)
    reset_counts()
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    got_counts = counts()
    require(got_counts == PER_FORWARD[label],
            f"{label}: launches {got_counts} != {PER_FORWARD[label]}")
    with torch.no_grad():
        ref = cpu_model(x.cpu())
    require(counts() == got_counts, "a CPU forward launched a kernel")
    flips = ""
    if cfg.method == "dyvit":
        flips = dyvit_check(label, tag, dtype, cfg, v, v_ref)
    elif cfg.method in CLUSTER_DECISIONS:
        flips = cluster_check(label, tag, dtype, cfg, v, v_ref)
    elif cfg.method == "topk":
        n_flip = sum(int((v["Kept_Tokens"][i].cpu() != k).sum())
                     for i, k in v_ref["Kept_Tokens"].items())
        # kept ids that the CPU kept too, in any order
        n_kept = sum(int(torch.isin(a, b).sum())
                     for i, k in v_ref["Kept_Tokens"].items()
                     for a, b in zip(v["Kept_Tokens"][i].cpu(), k))
        n_all = sum(k.numel() for k in v_ref["Kept_Tokens"].values())
        widths = [k.shape[1] + 1 for k in v_ref["Kept_Tokens"].values()]
        flips = (f"; widths 197->{'->'.join(map(str, widths))}; "
                 f"Kept_Tokens flips {n_flip}/{n_all}, same kept set "
                 f"{n_kept}/{n_all} (bound {KEPT_SET[dtype]})")
        require(n_kept >= KEPT_SET[dtype] * n_all,
                f"{label} {tag}: only {n_kept}/{n_all} kept ids in the "
                "CPU's kept set")
    elif cfg.method == "heuristic":
        kept, ref_kept = v["Kept_Tokens_Abs"], v_ref["Kept_Tokens_Abs"]
        require(sorted(kept) == sorted(ref_kept) and all(
            torch.equal(kept[i].cpu(), k) for i, k in ref_kept.items()),
            f"{label} {tag}: Kept_Tokens_Abs differ from the CPU's")
        flips = (f"; Kept_Tokens_Abs equal at blocks {sorted(kept)}, "
                 "kept patches " + "->".join(
                     str(kept[i].shape[-1]) for i in sorted(kept)))
    elif cfg.method == "ats":
        flips = ats_check(label, tag, dtype, model, x, cfg, out, v, v_ref)
        reset_counts()
    elif cfg.method == "tome":
        maps, ref_maps = v["Assignment_Maps"], v_ref["Assignment_Maps"]
        require(sorted(maps) == sorted(ref_maps) == list(cfg.reduction_loc),
                f"{label} {tag}: merges at {sorted(maps)}")
        n_same = sum(int((maps[i].cpu() == a).sum())
                     for i, a in ref_maps.items())
        n_all = sum(a.numel() for a in ref_maps.values())
        flips = (f"; widths 197->{'->'.join(map(str, v['widths']))}; "
                 f"Assignment_Maps entries equal {n_same}/{n_all} "
                 f"({n_same / n_all:.4f}, bound {ASSIGN_SAME[dtype]})")
        require(n_same >= ASSIGN_SAME[dtype] * n_all,
                f"{label} {tag}: only {n_same}/{n_all} assignment "
                "entries equal the CPU's")
        if dtype == torch.bfloat16:
            # the merge is deterministic: a second forward, same bits
            record_decisions(model)  # a fresh record for its merges
            with torch.no_grad():
                again = model(x)
            require(torch.equal(again, out),
                    f"{label} {tag}: two forwards differ")
            flips += "; a second forward gave the same logits"
            reset_counts()
    out = out.cpu()
    require(out.shape == (B, cfg.num_classes) and
            bool(torch.isfinite(out).all()), f"{label}: bad logits")
    err, rel = rel_err(out, ref)
    top1 = (out.argmax(1) == ref.argmax(1)).float().mean().item()
    # heuristic makes no data-dependent decision and DyViT's CPU model
    # takes the card's (share_scores): their bf16 logits are held like
    # dense's
    if dtype == torch.bfloat16 and cfg.method not in (
            "", "heuristic", "dyvit"):
        limit = "reported only"
    else:
        limit = f"bound {bound_:.0e}"
        require(rel <= bound_, f"{label} {tag}: logits error {rel:.3e} "
                f"of max|CPU| > {bound_:.0e}")
    top1_bound = MODEL_TOP1[dtype]
    if dtype == torch.bfloat16:
        top1_bound = CLUSTER_BF16.get(label, (top1_bound,))[0]
    require(top1 >= top1_bound, f"{label} {tag}: top-1 agreement "
            f"{top1:.3f} < {top1_bound}")
    print(f"phase 3 model {label} ({name}) {tag} B={B}: logits max abs "
          f"err {err:.3e} ({rel:.2e} of max|CPU|, {limit}); "
          f"top-1 agreement {top1:.3f} (bound {top1_bound}); "
          f"launches {got_counts}{flips}", flush=True)


# each reducing model's viz artifacts with per-token decisions, compared
# in place with the CPU's (heuristic's are static)
VIZ_DECISIONS = {"topk": "Kept_Tokens", "tome": "Assignment_Maps",
                 "ats": "Kept_Tokens", "heuristic": "Kept_Tokens_Abs",
                 "dyvit": "Kept_Tokens", "evit": "Kept_Tokens",
                 "kmedoids": "Kept_Tokens", "dpcknn": "Kept_Tokens",
                 "sinkhorn": "Assignment_Maps",
                 "patchmerger": "Assignment_Maps", "sit": "Assignment_Maps"}
# EViT's and the cluster family's decisions, each held in place against
# the CPU's
CLUSTER_DECISIONS = {"evit": ("Kept_Tokens", "Fusion_Assign"),
                     "kmedoids": ("Kept_Tokens", "Assignment_Maps"),
                     "dpcknn": ("Kept_Tokens", "Assignment_Maps"),
                     "sinkhorn": ("Assignment_Maps",),
                     "patchmerger": ("Assignment_Maps",),
                     "sit": ("Assignment_Maps",)}
# fp32: k-medoids' and DPC-KNN's share of ids equal in place to the CPU's
# own (their CPU model takes the card's ids, record_clustering; measured:
# 1 k-medoids medoid of 2400 flipped in a training forward, 4 in a viz
# forward)
CLUSTER_FP32_SAME = 0.99
# a soft assignment's argmax may differ from the CPU's only where the
# CPU's soft values tie within this share of the map's max: with random
# weights the first stage averages the tokens nearly alike, and the later
# stages' soft maps are uniform to the last fp32 bits
SOFT_TIE = 1e-5
# fp32: the soft assignments, of max|CPU|. PatchMerger's from its measured
# 1.17e-3: its unscaled logits (N(0, 1) queries against LayerNormed tokens,
# up to about 90) carry the devices' 1e-6 differences of the tokens
# through exp
SOFT_BOUND = {"sinkhorn": 1e-4, "sit": 1e-4, "patchmerger": 5e-3}
# bf16 B=32 against the CPU: (top-1 agreement, share of each decision's
# entries equal in place; EViT: of its kept ids in the CPU's kept set),
# bounds set from measured runs (top-1 0.969-1.0; EViT's kept set 0.934,
# k-medoids' ids 0.841-0.848, DPC-KNN's 0.648-0.706 (the CPU model taking
# the card's ids), Sinkhorn's maps 0.485, PatchMerger's 0.980, SiT's
# 0.901). Random weights make near-uniform attention and soft maps, whose
# scores lie closer than a bf16 ulp
CLUSTER_BF16 = {"evit@0.7": (0.9, 0.9), "kmedoids@0.7": (0.9, 0.8),
                "dpcknn@0.7": (0.9, 0.6), "sinkhorn@0.7": (0.9, 0.4),
                "patchmerger@0.7": (0.9, 0.95), "sit@0.7": (0.9, 0.85)}


def soft_ties(label, tag, got, want, soft, soft_ref, bound_) -> str:
    """The soft trio's checks in fp32: each block's soft assignments
    within ``bound_`` of max|CPU| (SOFT_BOUND), and each Assignment_Maps
    entry that differs from the CPU's a tie of the CPU's soft values
    (SOFT_TIE). Returns the report."""
    n_ties = worst = 0
    for i, w in want.items():
        worst = max(worst, rel_err(soft[i].cpu(), soft_ref[i])[1])
        g = got[i].cpu()
        at_card = soft_ref[i].gather(-2, g[:, None, :])[:, 0]
        gap = soft_ref[i].amax(-2) - at_card
        flipped = g != w
        untied = flipped & (gap > SOFT_TIE * soft_ref[i].abs().max())
        require(not bool(untied.any()), f"{label} {tag}: Assignment_Maps at "
                f"block {i} differ from the CPU's in {int(untied.sum())} "
                "places where its soft values do not tie")
        n_ties += int(flipped.sum())
    require(worst <= bound_, f"{label} {tag}: soft assignments {worst:.2e} "
            f"of max|CPU| > {bound_:.0e}")
    return (f", the other {n_ties} ties of the CPU's soft values (within "
            f"{SOFT_TIE:.0e} of the map's max); soft assignments within "
            f"{worst:.2e} of max|CPU| (bound {bound_:.0e})")


def cluster_check(label, tag, dtype, cfg, v, v_ref) -> str:
    """Phase 3's checks of EViT's and the cluster family's recorded
    decisions: the reduction blocks, and the entries equal in place to the
    CPU's. fp32: EViT's all; k-medoids' and DPC-KNN's CLUSTER_FP32_SAME
    (their CPU model takes the card's ids); the soft trio's all but ties
    (soft_ties). bf16: CLUSTER_BF16's share, EViT's kept ids in the CPU's
    kept set. Returns the report."""
    widths = [1 + k + (cfg.method == "evit")
              for k in reduction_schedule(cfg)]
    report = f"; widths 197->{'->'.join(map(str, widths))}"
    share = CLUSTER_BF16[label][1]
    if dtype == torch.float32 and cfg.method in ("kmedoids", "dpcknn"):
        share = CLUSTER_FP32_SAME
    if cfg.method in ("kmedoids", "dpcknn"):
        report += " (the CPU takes the card's ids)"
    for key in CLUSTER_DECISIONS[cfg.method]:
        got, want = v[key], v_ref[key]
        require(sorted(got) == sorted(want) == list(cfg.reduction_loc),
                f"{label} {tag}: {key} at {sorted(got)}, on the CPU "
                f"{sorted(want)}")
        n_same = sum(int((got[i].cpu() == w).sum()) for i, w in want.items())
        n_all = sum(w.numel() for w in want.values())
        report += f"; {key} equal in place {n_same}/{n_all}"
        if dtype == torch.float32 and cfg.method == "evit":
            require(n_same == n_all, f"{label} {tag}: {key} differ from the "
                    f"CPU's in {n_all - n_same} of {n_all} entries")
        elif dtype == torch.float32 and "Soft_Assignment_Maps" in v:
            report += soft_ties(label, tag, got, want,
                                v["Soft_Assignment_Maps"],
                                v_ref["Soft_Assignment_Maps"],
                                SOFT_BOUND[cfg.method])
        elif cfg.method == "evit":
            if key == "Kept_Tokens":  # the kept patches, in any order
                n_kept = sum(int(torch.isin(a, b).sum())
                             for i, w in want.items()
                             for a, b in zip(got[i].cpu()[:, :-1],
                                             w[:, :-1]))
                n_ids = sum(w[:, :-1].numel() for w in want.values())
                report += (f", same kept set {n_kept}/{n_ids} (bound "
                           f"{share})")
                require(n_kept >= share * n_ids, f"{label} {tag}: only "
                        f"{n_kept}/{n_ids} kept ids in the CPU's kept set")
                require(all(bool((got[i][:, -1] == -1).all()) for i in got),
                        f"{label} {tag}: the fused token's -1 is missing")
        else:
            report += f" ({n_same / n_all:.4f}, bound {share})"
            require(n_same >= share * n_all, f"{label} {tag}: only "
                    f"{n_same}/{n_all} {key} entries equal the CPU's")
    return report


def viz_check(label, name, kw, B):
    """A reducing model in viz mode, fp32, on the card against the CPU:
    no kernel may launch (the pin); the logits and the decisions in
    place against the CPU's viz run are reported."""
    model, cfg = create_model(name, device=DEVICE, viz_mode=True,
                              generator=torch.Generator().manual_seed(1),
                              **kw)
    model = model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    x = images(B, torch.Generator().manual_seed(2))
    reset_counts()
    with torch.no_grad():
        out, viz = model(x)
    torch.cuda.synchronize()
    require(counts() == NONE and not any(launcher_counts().values()),
            f"{label} viz: launches {counts()}, {launcher_counts()}: the "
            "viz pin must run no kernel")
    with torch.no_grad():
        ref, viz_ref = cpu_model(x.cpu())
    key = VIZ_DECISIONS[cfg.method]
    got, want = viz[key], viz_ref[key]
    require(sorted(got) == sorted(want), f"{label} viz: {key} at "
            f"{sorted(got)}, on the CPU {sorted(want)}")
    n_same = sum(int((got[i].cpu() == w).sum()) for i, w in want.items())
    n_all = sum(w.numel() for w in want.values())
    out = out.cpu()
    require(out.shape == (B, cfg.num_classes) and
            bool(torch.isfinite(out).all()), f"{label} viz: bad logits")
    err, rel = rel_err(out, ref)
    print(f"phase 3 viz {label} ({name}) fp32 B={B}: launches 0 (the viz "
          f"pin); logits max abs err {err:.3e} ({rel:.2e} of max|CPU|, "
          f"reported); {key} ids equal in place {n_same}/{n_all} "
          "(reported)", flush=True)


def wide_check(B, bound_):
    """Dense DeiT-S on a WIDE_IMG-pixel input (N = 290), fp32: a block
    wider than the fused full block's 256 tokens runs its two halves,
    every attention half fused_block_attention on the wide fp32 kernel
    (csrc/attention_wide_tf32.cu), every MLP half fused_mlp_residual, and
    the logits are held like the dense model's."""
    dtype, tag = torch.float32, "fp32"
    model, cfg = create_model("deit_small_patch16_224_local", device=DEVICE,
                              img_size=WIDE_IMG,
                              generator=torch.Generator().manual_seed(1))
    model = model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    x = torch.randn(B, 3, WIDE_IMG, WIDE_IMG,
                    generator=torch.Generator().manual_seed(2)).to(DEVICE,
                                                                   dtype)
    reset_counts()
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    want = {**NONE, "fused_block_attention": cfg.depth,
            "fused_mlp_residual": cfg.depth}
    require(counts() == want and _build.short_attention_heads
            .wide_tf32_launches == cfg.depth, f"dense N=290 {tag}: launches "
            f"{counts()}, wide {wide_counts()}, expected {want} and "
            f"{cfg.depth} attention_wide_tf32")
    with torch.no_grad():
        ref = cpu_model(x.cpu())
    out = out.cpu()
    require(out.shape == (B, cfg.num_classes) and
            bool(torch.isfinite(out).all()), "dense N=290: bad logits")
    err, rel = rel_err(out, ref)
    top1 = (out.argmax(1) == ref.argmax(1)).float().mean().item()
    require(rel <= bound_, f"dense N=290 {tag}: logits error {rel:.3e} of "
            f"max|CPU| > {bound_:.0e}")
    require(top1 >= MODEL_TOP1[dtype], f"dense N=290 {tag}: top-1 "
            f"agreement {top1:.3f} < {MODEL_TOP1[dtype]}")
    print(f"phase 3 wide dense {WIDE_IMG} px, N="
          f"{cfg.num_patches + 1} {tag} B={B}: fused_block_attention and "
          f"fused_mlp_residual launches {cfg.depth} each, attention_wide_tf32 "
          f"{cfg.depth}; logits max abs err "
          f"{err:.3e} ({rel:.2e} of "
          f"max|CPU|, bound {bound_:.0e}); top-1 agreement {top1:.3f}",
          flush=True)


def share_scores(model, cpu_model):
    """DyViT in bf16: the CPU model's score predictors return the card's
    scores, so both sides keep the same tokens and the rest of the forward
    is compared. With random weights the predictors' keep log-probabilities
    all lie within about 1e-3 of log(1/2), where a bf16 ulp is 2e-3: most
    bf16 scores tie exactly, the stable sort keeps the lowest ids among the
    tokens the roundings leave on top, and each side's own predictors keep
    tokens nearly at random against the other's (measured: 7054/9600 kept
    tokens in the CPU's set, where a random 70% would share 0.7, and top-1
    agreement 0.719 at B=32)."""
    scores = {}
    for s, (pred, cpu_pred) in enumerate(zip(model.score_predictor,
                                             cpu_model.score_predictor)):
        pred.register_forward_hook(
            lambda mod, args, out, s=s: scores.__setitem__(s, out.cpu()))
        cpu_pred.register_forward_hook(lambda mod, args, out, s=s: scores[s])


def dyvit_check(label, tag, dtype, cfg, viz, viz_ref) -> str:
    """Phase 3's DyViT checks: the reduction blocks and widths, and the
    kept tokens as absolute patch ids (each stage's ids chained through the
    stages before it), all in the CPU's kept set at the same stage (in
    bf16 by construction: share_scores). Returns the report, which also
    counts the Kept_Tokens ids equal in place: two kept tokens whose scores
    lie a few ulps apart can swap places, which renumbers the next stage's
    ids but keeps the same tokens."""
    kept, ref_kept = viz["Kept_Tokens"], viz_ref["Kept_Tokens"]
    require(sorted(kept) == sorted(ref_kept) == list(cfg.reduction_loc),
            f"{label} {tag}: reductions at {sorted(kept)}")
    widths = tuple(kept[i].shape[1] + 1 for i in cfg.reduction_loc)
    require(widths == DYVIT_WIDTHS, f"{label} {tag}: widths {widths}")
    ids = ref_ids = None
    n_kept = n_all = n_in_place = 0
    for i in cfg.reduction_loc:
        got, k = kept[i].cpu(), ref_kept[i]
        n_in_place += int((got == k).sum())
        ids = got if ids is None else torch.gather(ids, 1, got)
        ref_ids = k if ref_ids is None else torch.gather(ref_ids, 1, k)
        n_kept += sum(int(torch.isin(a, b).sum())
                      for a, b in zip(ids, ref_ids))
        n_all += k.numel()
    require(n_kept == n_all, f"{label} {tag}: only {n_kept}/{n_all} kept "
            "tokens in the CPU's kept set")
    shared = " (the card's scores)" if dtype == torch.bfloat16 else ""
    return (f"; widths 197->{'->'.join(map(str, widths))}; kept tokens "
            f"(absolute ids) in the CPU's kept set{shared} {n_kept}/{n_all}, "
            f"Kept_Tokens ids equal in place {n_in_place}/{n_all}")


# ATS@0.7's widths on DeiT-S: sample counts 138, 97, 68, each slot count
# num_sample_steps(K) + 1
ATS_WIDTHS = (138, 97, 68)


def ats_check(label, tag, dtype, model, x, cfg, out, viz, viz_ref) -> str:
    """Phase 3's ATS checks on the recorded decisions (record_decisions):
    the sampling blocks and widths; the share of Kept_Tokens equal to the
    CPU's (fp32 all of them); bf16 two forwards with the same bits (logits
    and Kept_Tokens). Returns the report."""
    kept, ref_kept = viz["Kept_Tokens"], viz_ref["Kept_Tokens"]
    require(sorted(kept) == sorted(ref_kept) == list(cfg.reduction_loc),
            f"{label} {tag}: samples at {sorted(kept)}")
    widths = tuple(kept[i].shape[1] + 1 for i in cfg.reduction_loc)
    require(widths == ATS_WIDTHS, f"{label} {tag}: widths {widths}")
    n_same = sum(int((kept[i].cpu() == k).sum()) for i, k in ref_kept.items())
    n_all = sum(k.numel() for k in ref_kept.values())
    pads = sum(int((k == -1).sum()) for k in kept.values())
    report = (f"; widths 197->{'->'.join(map(str, widths))}; Kept_Tokens "
              f"equal {n_same}/{n_all} ({n_same / n_all:.4f}, bound "
              f"{ATS_SAME[dtype]}), pad slots {pads}")
    require(n_same >= ATS_SAME[dtype] * n_all, f"{label} {tag}: only "
            f"{n_same}/{n_all} Kept_Tokens equal the CPU's")
    if dtype == torch.bfloat16:
        first = dict(kept)  # the record's hooks refill it
        with torch.no_grad():
            again = model(x)
        require(torch.equal(again, out) and all(
            torch.equal(kept[i], k) for i, k in first.items()),
            f"{label} {tag}: two forwards differ")
        report += "; a second forward gave the same logits and Kept_Tokens"
    return report


def label_smoothing_loss(out, targets, images_, params):
    return losses.label_smoothing_ce(out, targets, 0.1)


def record_kept(model, follow: dict | None = None) -> dict:
    """Record the top-k ids each reduction block gathers in training; with
    ``follow`` (another model's record), gather its ids instead, so that
    a near tie cannot send the two runs to different tokens."""
    kept = {}
    for i in model.cfg.reduction_loc:
        blk = model.blocks[i]

        def gather(x, idx, generator=None, i=i, inner=blk.ffn_gather):
            kept[i] = idx.detach().cpu()
            if follow is not None:
                idx = follow[i].to(idx.device)
            return inner(x, idx, generator)

        blk.ffn_gather = gather
    return kept


MATCHING = tome_model.bipartite_soft_matching
MERGES = {"cuda": {}, "cpu": {}}  # device type -> {merge: [B, t] ids}


def recorded_matching(metric, r, **kw):
    """ToMe's matching, recording each merge's ids (source, destination,
    then the unmerged) by the device it ran on."""
    info = MATCHING(metric, r, **kw)
    merges = MERGES[metric.device.type]
    merges[len(merges)] = torch.cat(
        [info.src_idx, info.dst_idx, info.unm_idx], 1).cpu()
    return info


def phase_train_models(dtype):
    """Phase 3, training: the loss and every gradient of one train step of
    the full-width models on the card against the CPU (drop_path 0), and
    the launches of one whole train step."""
    tome_model.bipartite_soft_matching = recorded_matching
    record_clusterings(True)
    try:
        for label in TRAIN_MODELS + (CLUSTER_TRAIN if dtype == torch.float32
                                     else ()):
            train_model_check(label, dtype)
    finally:
        tome_model.bipartite_soft_matching = MATCHING
        record_clusterings(False)


def train_model_check(label, dtype):
    """One model's phase 3 training check (see phase_train_models)."""
    tag = "fp32" if dtype == torch.float32 else "bf16 amp"
    B, bound_ = MODEL_BATCH[dtype], TRAIN_BOUND[dtype]
    cfg = StepConfig(amp=dtype == torch.bfloat16)
    name, kw = MODELS[label]
    model, _ = create_model(name, device=DEVICE,
                            generator=torch.Generator().manual_seed(1),
                            **kw)
    cpu_model = copy.deepcopy(model).cpu()
    merging = model.cfg.method == "tome"
    if merging:
        kept, cpu_kept = MERGES["cuda"], MERGES["cpu"]
        kept.clear()
        cpu_kept.clear()
    elif model.cfg.method == "kmedoids":  # the medoid ids
        kept = record_decisions(model)["Kept_Tokens"]
        cpu_kept = record_decisions(cpu_model)["Kept_Tokens"]
    else:
        kept, cpu_kept = record_kept(model), record_kept(cpu_model)
    gen = torch.Generator().manual_seed(2)
    x = images(B, gen)
    y = torch.randint(0, 1000, (B,), generator=gen).to(DEVICE)
    opt, _ = create_optimizer(dict(model.named_parameters()),
                              OptimConfig(lr=1e-3, clip_grad=1.0,
                                          backbone_lr_scale=0.01),
                              lambda s: 1e-3, [])
    state = init_train_state(model, opt, device=DEVICE)
    cpu_state = init_train_state(cpu_model, opt, device="cpu")
    model.train()
    cpu_model.train()
    reset_counts()
    loss, grads = loss_and_grads(model, label_smoothing_loss, state.params,
                                 x, y, cfg)
    torch.cuda.synchronize()
    fwd_bwd = counts()
    require(fwd_bwd == PER_TRAIN_STEP[label] and
            backward_counts() == PER_TRAIN_STEP_BWD[label],
            f"{label} {tag}: launches {fwd_bwd}, backward "
            f"{backward_counts()}")
    cpu_loss, cpu_grads = loss_and_grads(cpu_model, label_smoothing_loss,
                                         cpu_state.params, x.cpu(),
                                         y.cpu(), cfg)
    require(counts() == fwd_bwd, "a CPU train step launched a kernel")
    _, loss_rel = rel_err(loss.cpu().reshape(1), cpu_loss.reshape(1))
    ref, cpu_bf16 = "CPU", ""
    if dtype == torch.bfloat16 and label in FP32_GRAD_REF:
        ref, cpu_grads, bf16_grads = "CPU fp32", loss_and_grads(
            cpu_model, label_smoothing_loss, cpu_state.params, x.cpu(),
            y.cpu(), StepConfig())[1], cpu_grads
        off = {n: rel_err(g, cpu_grads[n])[1] for n, g in bf16_grads.items()}
        n_off = max(off, key=off.get)
        cpu_bf16 = (f"; the CPU's own bf16 gradients: worst leaf {n_off} "
                    f"{off[n_off]:.2e} of its max|CPU fp32| (reported)")
    worst_name, worst = "", 0.0
    for n, g in grads.items():
        _, rel = rel_err(g.cpu(), cpu_grads[n])
        if rel >= worst:
            worst_name, worst = n, rel
    require(sorted(kept) == sorted(cpu_kept),
            f"{label} {tag}: selections at {sorted(kept)} and, on the "
            f"CPU, {sorted(cpu_kept)}")
    n_all = sum(k.numel() for k in cpu_kept.values())
    in_place = sum(int((kept[i] == cpu_kept[i]).sum()) for i in cpu_kept)
    require(loss_rel <= bound_["loss"], f"{label} {tag}: loss "
            f"{loss_rel:.3e} of max|CPU| > {bound_['loss']:.0e}")
    if merging:  # merge ids (src, dst, unmerged), equal in place
        what = (f"merge ids equal {in_place}/{n_all} ("
                f"{'bound 1.0' if dtype == torch.float32 else 'reported'}"
                ")")
    else:
        # k-medoids' CPU model takes the card's medoids (record_clustering)
        following = model.cfg.method == "kmedoids"
        kept_set = CLUSTER_FP32_SAME if following else bound_["kept_set"]
        same_set = sum(int(torch.isin(a, b).sum()) for i in cpu_kept
                       for a, b in zip(kept[i], cpu_kept[i]))
        require(same_set >= kept_set * n_all,
                f"{label} {tag}: only {same_set}/{n_all} kept ids in the "
                "CPU's kept set")
        what = (f"kept ids in place {in_place}/{n_all}, in the CPU's kept "
                f"set {same_set}/{n_all} (bound {kept_set})"
                + ("; the CPU takes the card's medoids" if following else ""))
    if dtype == torch.float32:
        require(in_place >= (CLUSTER_FP32_SAME if model.cfg.method ==
                             "kmedoids" else 1.0) * n_all,
                f"{label} {tag}: selections differ from the CPU's")
    # gradients are held where the selection is exact or absent
    grads_held = dtype == torch.float32 or not cpu_kept
    if grads_held:
        require(worst <= bound_["grads"], f"{label} {tag}: gradient "
                f"{worst_name} {worst:.3e} of max|{ref}| > "
                f"{bound_['grads']:.0e}")
    # one whole train step: the launches of both counterparts
    step = make_train_step(model, label_smoothing_loss, opt, cfg)
    reset_counts()
    state, metrics = step(state, {"image": x, "label": y})
    torch.cuda.synchronize()
    require(counts() == PER_TRAIN_STEP[label] and
            backward_counts() == PER_TRAIN_STEP_BWD[label],
            f"{label} {tag}: train step launches {counts()}")
    require(bool(torch.isfinite(metrics["loss"])), f"{label}: bad loss")
    limit = (f"bound {bound_['grads']:.0e}" if grads_held
             else "reported only")
    print(f"phase 3 train {label} {tag} B={B}: loss {loss.item():.6f} vs "
          f"CPU {cpu_loss.item():.6f} ({loss_rel:.2e} rel, bound "
          f"{bound_['loss']:.0e}); worst gradient leaf {worst_name} "
          f"{worst:.2e} of its max|{ref}| ({limit}){cpu_bf16}; {what}; "
          f"launches of one train step {counts()}, backward "
          f"{backward_counts()}",
          flush=True)


# Sinkhorn's gradients: a leaf whose max|CPU| lies below this share of
# the largest leaf's is held to 1e-4 of that floor. With random weights
# the first stage averages the tokens nearly alike, the later stages' soft
# assignments are uniform, and the true gradient of their cluster vectors
# vanishes: what is left is rounding (the report prints those leaves'
# max|CPU| beside the largest leaf's)
SINKHORN_GRAD_FLOOR = 1e-6


def sinkhorn_step_check():
    """Sinkhorn@0.7 in fp32 at B=8 with its cluster layers at full LR: the
    loss and every gradient on the card within 1e-4 of each leaf's
    max|CPU| (SINKHORN_GRAD_FLOOR); then one train step with
    project_sinkhorn on the card, whose cluster vectors (drawn N(0, 1))
    must have rows of unit norm after it, with the launches of one train
    step."""
    label, B = "sinkhorn@0.7", MODEL_BATCH[torch.float32]
    name, kw = MODELS[label]
    model, _ = create_model(name, device=DEVICE,
                            generator=torch.Generator().manual_seed(1), **kw)
    cpu_model = copy.deepcopy(model).cpu()
    gen = torch.Generator().manual_seed(2)
    x = images(B, gen)
    y = torch.randint(0, 1000, (B,), generator=gen).to(DEVICE)
    cfg = StepConfig(project_sinkhorn=True)
    opt, _ = create_optimizer(dict(model.named_parameters()),
                              OptimConfig(lr=1e-3, clip_grad=1.0,
                                          backbone_lr_scale=0.01),
                              lambda s: 1e-3, model.new_module_names())
    state = init_train_state(model, opt, device=DEVICE)
    cpu_state = init_train_state(cpu_model, opt, device="cpu")
    model.train()
    cpu_model.train()
    loss, grads = loss_and_grads(model, label_smoothing_loss, state.params,
                                 x, y, cfg)
    cpu_loss, cpu_grads = loss_and_grads(cpu_model, label_smoothing_loss,
                                         cpu_state.params, x.cpu(), y.cpu(),
                                         cfg)
    _, loss_rel = rel_err(loss.cpu().reshape(1), cpu_loss.reshape(1))
    # each leaf of the larger of its max|CPU| and SINKHORN_GRAD_FLOOR of
    # the largest leaf's
    top = max(g.abs().max().item() for g in cpu_grads.values())
    floor = SINKHORN_GRAD_FLOOR * top
    worst_name, worst = max(
        ((n, (g.cpu() - cpu_grads[n]).abs().max().item()
          / max(cpu_grads[n].abs().max().item(), floor))
         for n, g in grads.items()), key=lambda t: t[1])
    at_floor = {n: f"{g.abs().max().item():.1e}"
                for n, g in sorted(cpu_grads.items())
                if g.abs().max().item() < floor}
    require(loss_rel <= 1e-4 and worst <= 1e-4, f"{label}: loss "
            f"{loss_rel:.2e}, gradient {worst_name} {worst:.2e} of its "
            "max|CPU|")
    vs = [n for n in state.params if n.endswith(".v")]
    before = max(torch.linalg.vector_norm(state.params[n], dim=-1).min()
                 .item() for n in vs)
    step = make_train_step(model, label_smoothing_loss, opt, cfg)
    reset_counts()
    state, metrics = step(state, {"image": x, "label": y})
    torch.cuda.synchronize()
    step_counts = counts()
    require(step_counts == PER_TRAIN_STEP[label],
            f"{label}: train step launches {step_counts}")
    norm_err = max((torch.linalg.vector_norm(state.params[n], dim=-1) - 1)
                   .abs().max().item() for n in vs)
    require(len(vs) == 3 and norm_err <= 1e-5 and
            bool(torch.isfinite(metrics["loss"])), f"{label}: cluster "
            f"vectors {vs} off the unit sphere by {norm_err:.2e}")
    print(f"phase 3 train {label} fp32 B={B}: loss {loss.item():.6f} vs CPU "
          f"{cpu_loss.item():.6f} ({loss_rel:.2e} rel, bound 1e-4); worst "
          f"gradient leaf {worst_name} {worst:.2e} of its max|CPU| (bound "
          f"1e-4; below {SINKHORN_GRAD_FLOOR:.0e} of the largest leaf's "
          f"{top:.2e}, held to 1e-4 of that: {at_floor}); "
          f"one step with project_sinkhorn: the {len(vs)} cluster "
          f"vectors' rows (norms from {before:.1f} before) of unit norm "
          f"within {norm_err:.1e}; launches of one train step "
          f"{step_counts}", flush=True)


def dropout_step_check():
    """One bf16 amp train step of dense DeiT-S with drop_rate and
    attn_drop_rate 0.1, its masks from a seeded CUDA generator, run twice
    from the same start (cuDNN held to its deterministic algorithms for
    the patch embedding's backward): the loss and every parameter after
    the step must be the same bits. A third step from another seed must
    give another loss."""
    B = MODEL_BATCH[torch.bfloat16]
    gen = torch.Generator().manual_seed(2)
    x = images(B, gen)
    y = torch.randint(0, 1000, (B,), generator=gen).to(DEVICE)

    def step_once(seed):
        model, _ = create_model(MODELS["dense"][0], device=DEVICE,
                                drop_rate=0.1, attn_drop_rate=0.1,
                                generator=torch.Generator().manual_seed(1))
        opt, _ = create_optimizer(dict(model.named_parameters()),
                                  OptimConfig(lr=1e-3, clip_grad=1.0,
                                              backbone_lr_scale=0.01),
                                  lambda s: 1e-3, [])
        state = init_train_state(model, opt, device=DEVICE)
        masks = torch.Generator(device=DEVICE).manual_seed(seed)
        step = make_train_step(model, label_smoothing_loss, opt,
                               StepConfig(amp=True), masks)
        state, metrics = step(state, {"image": x, "label": y})
        return metrics["loss"], state.params

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        (la, pa), (lb, pb), (lc, _) = step_once(7), step_once(7), step_once(8)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = torch.equal(la, lb) and all(torch.equal(pa[n], pb[n]) for n in pa)
    require(bool(torch.isfinite(la)) and same, "dropout train step: two "
            f"steps from one seed differ (loss {la.item()} vs {lb.item()})")
    require(not torch.equal(la, lc), "dropout train step: another seed "
            "gave the same loss")
    print(f"phase 3 dropout step dense bf16 amp B={B}, drop_rate and "
          f"attn_drop_rate 0.1: two steps from one CUDA generator seed gave "
          f"the same loss ({la.item():.6f}) and parameters, bit for bit; "
          f"another seed {lc.item():.6f}", flush=True)


def make_teacher(label: str, device=DEVICE):
    """A teacher of TEACHERS, fp32 with seeded weights (eval mode)."""
    model, _ = create_model(TEACHERS[label], device=device,
                            generator=torch.Generator().manual_seed(3))
    return model.eval()


def teacher_check(label: str):
    """Phase 3: a teacher's fp32 outputs at B=8 on the card against the
    same teacher on the CPU, each within 1e-4 of its max|CPU|, with the
    launches of one forward (the DyViT teacher: 12 fp32 full blocks; the
    RegNet: none, its convolutions are cuDNN's)."""
    B, bound_ = MODEL_BATCH[torch.float32], MODEL_BOUND[torch.float32]
    teacher = make_teacher(label)
    cpu_teacher = copy.deepcopy(teacher).cpu()
    x = images(B, torch.Generator().manual_seed(2))
    reset_counts()
    with torch.no_grad():
        out = as_list(teacher(x))
        torch.cuda.synchronize()
        got = counts()
        want = as_list(cpu_teacher(x.cpu()))
    launches = {**NONE, "fused_full_block": 12 if "dyvit" in label else 0}
    require(got == launches, f"teacher {label}: launches {got}")
    errs = []
    for what, o, w in zip(("logits", "tokens"), out, want):
        abs_err, rel = rel_err(o.cpu(), w)
        require(rel <= bound_, f"teacher {label} {what}: {rel:.3e} of "
                f"max|CPU| > {bound_:.0e}")
        errs.append(f"{what} {tuple(o.shape)} max abs err {abs_err:.3e} "
                    f"({rel:.2e} of max|CPU|)")
    top1 = (out[0].argmax(-1).cpu() == want[0].argmax(-1)).float().mean()
    require(top1.item() == 1.0, f"teacher {label}: top-1 {top1.item()}")
    print(f"phase 3 teacher {label} ({TEACHERS[label]}) fp32 B={B}: "
          f"{'; '.join(errs)} (bound {bound_:.0e}); top-1 equal; launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)


GUMBEL_UNIFORM = dyvit_ops.gumbel_uniform


class GumbelReplay:
    """DyViT's Gumbel uniforms, drawn and recorded until ``replay`` is set
    (the card's run), then handed out in the same order (the CPU's run),
    so that the CPU model takes the card's decisions, as k-medoids' CPU
    model takes the card's ids."""

    def __init__(self):
        self.draws, self.replay = [], False

    def __call__(self, shape, dtype, device, generator):
        if self.replay:
            return self.draws.pop(0).to(device)
        u = GUMBEL_UNIFORM(shape, dtype, device, generator)
        self.draws.append(u.cpu())
        return u


def timed_teacher(apply, events: list):
    """apply with a pair of CUDA events around each call, in ``events``."""
    def run(images):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = apply(images)
        end.record()
        events.append((start, end))
        return out
    return run


def distill_setup(label: str, device=DEVICE, amp: bool = False,
                  events: list | None = None):
    """(student, its loss_fn from train_loop.build_loss_fn with the
    teacher's train_loop.make_teacher_apply, the student's new module
    names) of a DISTILL_MODELS cell on ``device``, seeded weights; with
    ``amp`` bench.py's drop_path 0.1, with ``events`` the teacher's calls
    timed (timed_teacher)."""
    (name, kw), teacher_label, extra = DISTILL_MODELS[label]
    model, cfg = create_model(name, device=device,
                              generator=torch.Generator().manual_seed(1),
                              **kw, **({"drop_path_rate": 0.1} if amp
                                       else {}))
    args = argparse.Namespace(**{**LOOP_ARGS, **extra})
    teacher_apply = None
    if teacher_label is not None:
        teacher_apply = train_loop.make_teacher_apply(
            make_teacher(teacher_label, device))
        if events is not None:
            teacher_apply = timed_teacher(teacher_apply, events)
    loss_fn = train_loop.build_loss_fn(
        args, cfg, train_loop.build_base_criterion(args, False, False),
        teacher_apply)
    return model, loss_fn, getattr(model, "new_module_names", list)()


def distill_check(label: str, dtype=torch.float32):
    """Phase 3: the loss and every gradient of one training forward and
    backward on the card against the CPU (the CPU model takes the card's
    Gumbel uniforms; the teachers are the same on both devices, fp32 on
    the uncast images), DyViT's decisions in place, and the launches of
    one train step. fp32 at B=8: the loss and gradients within 1e-4, the
    decisions equal. bf16 amp at B=32: the loss within TRAIN_BOUND's, the
    share of decisions equal to the CPU's at least DYVIT_BF16_SAME (bf16
    scores tie within an ulp and their Gumbel argmax flips), the
    gradients, taken over other tokens where a decision flips, reported
    only."""
    fp32 = dtype == torch.float32
    tag = "fp32" if fp32 else "bf16 amp"
    B, bound_ = MODEL_BATCH[dtype], TRAIN_BOUND[dtype]
    cfg = StepConfig(amp=not fp32)
    model, loss_fn, new_names = distill_setup(label)
    cpu_model, cpu_loss_fn, _ = distill_setup(label, "cpu")  # same seeds
    gen = torch.Generator().manual_seed(2)
    x = images(B, gen)
    y = torch.randint(0, 1000, (B,), generator=gen).to(DEVICE)
    opt, _ = create_optimizer(dict(model.named_parameters()),
                              OptimConfig(lr=1e-3, clip_grad=1.0,
                                          backbone_lr_scale=0.01),
                              lambda s: 1e-3, new_names)
    state = init_train_state(model, opt, device=DEVICE)
    cpu_state = init_train_state(cpu_model, opt, device="cpu")
    outs = {}

    def recording(fn, dev):
        def run(out, *rest):
            outs[dev] = out
            return fn(out, *rest)
        return run

    model.train()
    cpu_model.train()
    gumbel = dyvit_ops.gumbel_uniform = GumbelReplay()
    try:
        reset_counts()
        loss, grads = loss_and_grads(
            model, recording(loss_fn, "cuda"), state.params, x, y, cfg,
            torch.Generator(device=DEVICE).manual_seed(4))
        torch.cuda.synchronize()
        got, got_bwd = counts(), backward_counts()
        require(got == PER_TRAIN_STEP[label]
                and got_bwd == PER_TRAIN_STEP_BWD[label],
                f"{label} {tag}: launches {got}, backward {got_bwd}")
        gumbel.replay = True
        cpu_loss, cpu_grads = loss_and_grads(
            cpu_model, recording(cpu_loss_fn, "cpu"), cpu_state.params,
            x.cpu(), y.cpu(), cfg, torch.Generator().manual_seed(4))
        require(counts() == got, "a CPU train step launched a kernel")
        require(not gumbel.draws,
                f"{label} {tag}: {len(gumbel.draws)} Gumbel draws unused")
    finally:
        dyvit_ops.gumbel_uniform = GUMBEL_UNIFORM
    _, loss_rel = rel_err(loss.cpu().reshape(1), cpu_loss.reshape(1))
    require(loss_rel <= bound_["loss"], f"{label} {tag}: loss "
            f"{loss_rel:.3e} of max|CPU| > {bound_['loss']:.0e}")
    worst_name, worst = max(((n, rel_err(g.cpu(), cpu_grads[n])[1])
                             for n, g in grads.items()), key=lambda t: t[1])
    require(not fp32 or worst <= bound_["grads"], f"{label} {tag}: gradient "
            f"{worst_name} {worst:.3e} of max|CPU| > {bound_['grads']:.0e}")
    limit = f"bound {bound_['grads']:.0e}" if fp32 else "reported only"
    what = ""
    if label.startswith("dyvit"):
        decided = [d.detach().round().cpu() for d in outs["cuda"][-1]]
        cpu_decided = [d.detach().round() for d in outs["cpu"][-1]]
        same = sum(int((a == b).sum()) for a, b in zip(decided, cpu_decided))
        total = sum(d.numel() for d in cpu_decided)
        least = 1.0 if fp32 else DYVIT_BF16_SAME
        require(same >= least * total, f"{label} {tag}: {total - same} of "
                f"{total} Gumbel decisions differ from the CPU's")
        kept = [f"{d.float().mean().item():.3f}" for d in decided]
        what = (f"; Gumbel decisions equal {same}/{total} ({same / total:.4f}"
                f", bound {least}), kept share a stage {kept}")
    step = make_train_step(model, loss_fn, opt, cfg,
                           torch.Generator(device=DEVICE).manual_seed(4))
    reset_counts()
    state, metrics = step(state, {"image": x, "label": y})
    torch.cuda.synchronize()
    require(counts() == PER_TRAIN_STEP[label]
            and backward_counts() == PER_TRAIN_STEP_BWD[label]
            and bool(torch.isfinite(metrics["loss"])),
            f"{label} {tag}: train step launches {counts()}, loss "
            f"{metrics['loss'].item()}")
    print(f"phase 3 train {label} {tag} B={B}: loss {loss.item():.6f} vs CPU "
          f"{cpu_loss.item():.6f} ({loss_rel:.2e} rel, bound "
          f"{bound_['loss']:.0e}); worst gradient leaf {worst_name} "
          f"{worst:.2e} of its max|CPU| ({limit}){what}; "
          f"launches of one train step "
          f"{ {k: v for k, v in counts().items() if v} }, backward "
          f"{ {k: v for k, v in backward_counts().items() if v} }",
          flush=True)


def phase_distill():
    """Phase 3, DyViT's training and the teachers: each teacher's outputs,
    then DyViT@0.7's training without and with dyvit_distill and the
    distilled DeiT-S with the RegNet teacher, soft and hard, in fp32, and
    DyViT@0.7's with dyvit_distill in bf16 amp."""
    for label in TEACHERS:
        teacher_check(label)
    for label in DISTILL_MODELS:
        distill_check(label)
    distill_check("dyvit@0.7 distill", torch.bfloat16)


def phase_serve(card: str) -> dict:
    """Phase 4: serve SERVE_BATCHES batches of SERVE_B bf16 images per
    model; the launch counts of this run go into the JSON record."""
    reset_counts()
    expected = dict.fromkeys(WRAPPERS, 0)
    for label, (name, kw) in MODELS.items():
        settle()
        model, cfg = create_model(name, device=DEVICE,
                                  generator=torch.Generator().manual_seed(1),
                                  **kw)
        model = model.to(torch.bfloat16).eval()
        # DPC-KNN's density noise, from a seeded CUDA generator
        noise = (torch.Generator(device=DEVICE).manual_seed(4)
                 if cfg.method == "dpcknn" else None)
        xs = images(SERVE_BATCHES * SERVE_B,
                    torch.Generator().manual_seed(3), torch.bfloat16) \
            .view(SERVE_BATCHES, SERVE_B, 3, 224, 224)
        seconds = []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                out = model(x, generator=noise)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                require(out.shape == (SERVE_B, 1000) and
                        bool(torch.isfinite(out).all()),
                        f"{label}: non-finite or misshapen bf16 logits")
        for k, n in PER_FORWARD[label].items():
            expected[k] += n * SERVE_BATCHES
        ips = SERVE_B * (SERVE_BATCHES - 1) / sum(seconds[1:])
        FORWARD_IPS[label, "bf16"] = ips
        print(f"phase 4 serve {label} bf16 b{SERVE_B}: {ips:.1f} img/s over "
              f"batches 2-{SERVE_BATCHES} (first batch "
              f"{seconds[0] * 1e3:.1f} ms) on {card}", flush=True)
        del model, xs
    got = counts()
    require(got == expected, f"serve launches {got} != {expected}")
    require(all(got[k] for k in EVAL_WRAPPERS),
            f"a kernel of the path never ran: {got}")
    require(not any(got[k] for k in OFF_PATH_WRAPPERS),
            f"a counterpart off the path ran: {got}")
    got.update(launcher_counts())
    require(got["gemm"] > 0 and got["gemm_wgrad"] == 0,
            f"serve gemm launches {launcher_counts()}")
    require(got["short_attention"] > 0 and got["short_attention_bwd"] == 0,
            f"serve attention launches {launcher_counts()}")
    require(not any(got[k] for k in FP32_LAUNCHERS),
            f"serve fp32 launches in a bf16 run {launcher_counts()}")
    # the rectangular attention: once in each of ATS's sampling blocks
    require(got["rect_attention"] == got["fused_rect_block"] > 0
            and got["layer_norm_bwd"] == 0 and got["sum_partials"] == 0,
            f"serve rectangular attention, LN backward and sum launches "
            f"{launcher_counts()}")
    # the head-mean keys: once in each of ToMe@0.7's three merging blocks
    require(got["head_mean_keys"] == 3 * SERVE_BATCHES,
            f"serve head_mean_keys launches {got['head_mean_keys']} != "
            f"{3 * SERVE_BATCHES}")
    print(f"phase 4 launches {got}", flush=True)
    for label in ("ats@0.7", "heuristic", "dyvit@0.7", *CLUSTERING):
        eval_profile(label, card,
                     profile=label in ("ats@0.7", "heuristic", "kmedoids@0.7",
                                       "dpcknn@0.7"))
    for label in CLUSTERING:
        if label != "evit@0.7":
            clustering_share(label, card)
    return got


# EViT and the cluster family: each serves with no host sync (phase 4)
CLUSTERING = ("evit@0.7", "kmedoids@0.7", "dpcknn@0.7", "sinkhorn@0.7",
              "patchmerger@0.7", "sit@0.7")


def clustering_share(label: str, card: str, forwards: int = 3):
    """The device time of a cluster model's clustering between the blocks
    (PyTorch ops: k_medoids_fit, or each cluster layer's forward) against
    its whole bf16 b256 forward: CUDA events recorded around each
    clustering call and around each forward, ``forwards`` forwards after
    one to warm up."""
    settle()
    name, kw = MODELS[label]
    model, cfg = create_model(name, device=DEVICE,
                              generator=torch.Generator().manual_seed(1),
                              **kw)
    model = model.to(torch.bfloat16).eval()
    x = images(SERVE_B, torch.Generator().manual_seed(3), torch.bfloat16)
    spans = []

    def mark(*_):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def start(*_):
        spans.append([mark()])

    def stop(*_):
        spans[-1].append(mark())

    def fit(*args, **kw_):
        start()
        out = KMEDOIDS_FIT(*args, **kw_)
        stop()
        return out

    if cfg.method == "kmedoids":
        cluster_model.k_medoids_fit = fit
    else:
        for layer in model.cluster_layers:
            layer.register_forward_pre_hook(start)
            layer.register_forward_hook(stop)
    try:
        with torch.no_grad():
            model(x)
            torch.cuda.synchronize()
            spans.clear()
            whole = []
            for _ in range(forwards):
                begin = mark()
                model(x)
                whole.append((begin, mark()))
            torch.cuda.synchronize()
    finally:
        cluster_model.k_medoids_fit = KMEDOIDS_FIT
    total = sum(a.elapsed_time(b) for a, b in whole) / forwards
    clustering = sum(a.elapsed_time(b) for a, b in spans) / forwards
    require(len(spans) == forwards * len(cfg.reduction_loc),
            f"{label}: {len(spans)} clustering calls timed")
    print(f"phase 4 clustering {label} bf16 b{SERVE_B}: {clustering:.3f} ms "
          f"of {total:.3f} ms per forward ({100 * clustering / total:.1f}%; "
          f"CUDA events around each of the {len(cfg.reduction_loc)} "
          f"clustering calls, {forwards} forwards) on {card}", flush=True)


def device_profile(run, steps: int):
    """(the device's busy share of the wall time of ``steps`` calls of
    run(i), {kernel family: device microseconds}) under torch.profiler, or
    None when the profiler saw no device events."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run(i)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = kernel_family(e.name)
            by_kernel[name] = by_kernel.get(name, 0.0) + \
                e.time_range.elapsed_us()
    device_us = sum(by_kernel.values())
    return (device_us / window_us, by_kernel) if device_us > 0 else None


def host_syncs(run) -> list[str]:
    """The waits for the card that PyTorch reports while run() executes
    (a copy between host and card, a value read back): each idles the card
    while the host queues the next kernels."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in caught]


def eval_profile(label: str, card: str, profile: bool = True):
    """One bf16 b256 forward of one model that must not wait for the card
    (after the counted serve run), then, with ``profile``, two forwards
    under torch.profiler: the device's busy share and its time by
    kernel."""
    settle()
    name, kw = MODELS[label]
    model, _ = create_model(name, device=DEVICE,
                            generator=torch.Generator().manual_seed(1), **kw)
    model = model.to(torch.bfloat16).eval()
    x = images(SERVE_B, torch.Generator().manual_seed(3), torch.bfloat16)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        syncs = host_syncs(lambda: model(x))
        require(not syncs, f"{label}: the eval forward waits for the card "
                f"{len(syncs)} times: {syncs[:3]}")
        print(f"phase 4 host syncs {label}: none in one bf16 b{SERVE_B} "
              "forward", flush=True)
        if not profile:
            return
        prof = device_profile(lambda i: model(x), 2)
    if prof is None:
        print(f"phase 4 profile {label}: device time not measured (the "
              "profiler saw no device events)", flush=True)
        return
    busy, by_kernel = prof
    total = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:14]
    print(f"phase 4 profile {label} bf16 b{SERVE_B}: device busy "
          f"{100 * busy:.1f}% of two forwards (torch.profiler); device time "
          f"{total / 2e3:.3f} ms per forward on {card}; by kernel: " +
          "; ".join(f"{n} {100 * us / total:.1f}%" for n, us in top),
          flush=True)


def train_run(label: str, steps: int, profile: bool = False,
              amp: bool = True, img_size: int = 224):
    """bench.py's train recipe for `steps` steps of TRAIN_B images
    (``amp`` false: in fp32, the JAX CLI's default) at ``img_size`` pixels;
    returns
    (seconds per step, losses, profile, extra) where profile, after two
    more steps under torch.profiler, is (the device's busy share of their
    wall time, {kernel: device microseconds}), else None; extra holds the
    peak memory allocated over the steps (torch.cuda.max_memory_allocated,
    the batches on the card included) and, for a DISTILL_MODELS cell, the
    teacher's mean ms a step over steps 3-`steps` (CUDA events around its
    forward). A DISTILL_MODELS cell trains with its loop's loss and
    teacher, and its student's new modules at full LR."""
    settle()
    torch.cuda.reset_peak_memory_stats()
    teacher_events = []
    if label in DISTILL_MODELS:
        model, loss_fn, new_names = distill_setup(label, amp=True,
                                                  events=teacher_events)
    else:
        name, kw = MODELS[label]
        model, _ = create_model(name, device=DEVICE, drop_path_rate=0.1,
                                generator=torch.Generator().manual_seed(1),
                                img_size=img_size, **kw)
        loss_fn, new_names = label_smoothing_loss, []
    opt, _ = create_optimizer(dict(model.named_parameters()),
                              OptimConfig(lr=1e-3, clip_grad=1.0,
                                          backbone_lr_scale=0.01),
                              lambda s: 1e-3, new_names)
    state = init_train_state(model, opt, ema=True, device=DEVICE)
    step = make_train_step(model, loss_fn, opt,
                           StepConfig(ema_decay=0.99996, amp=amp),
                           torch.Generator(device=DEVICE).manual_seed(5))
    data = torch.Generator(device=DEVICE).manual_seed(3)
    xs = torch.randn(steps, TRAIN_B, 3, img_size, img_size, generator=data,
                     device=DEVICE)
    ys = torch.randint(0, 1000, (steps, TRAIN_B), generator=data,
                       device=DEVICE)
    first = {n: p.detach().clone() for n, p in state.params.items()}
    seconds, step_losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, {"image": xs[i], "label": ys[i]})
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        step_losses.append(metrics["loss"])
    extra = dict(peak=torch.cuda.max_memory_allocated())
    if teacher_events:
        extra["teacher_ms"] = statistics.mean(
            a.elapsed_time(b) for a, b in teacher_events[2:steps])
    prof_out = None
    if profile:
        def run(i):
            nonlocal state
            state, _ = step(state, {"image": xs[i], "label": ys[i]})

        prof_out = device_profile(run, 2)
    step_losses = torch.stack(step_losses).cpu()
    require(bool(torch.isfinite(step_losses).all()),
            f"{label}: non-finite train losses {step_losses.tolist()}")
    moved = max((state.params[n] - p).abs().max().item()
                for n, p in first.items())
    ema_moved = max((state.ema_params[n] - p).abs().max().item()
                    for n, p in first.items())
    require(moved > 0 and ema_moved > 0,
            f"{label}: params moved {moved}, EMA {ema_moved}")
    return seconds, step_losses, prof_out, extra


def policy_attention_ms(B: int = TRAIN_B) -> float:
    """One DyViT attention half's plain composition under a policy
    (Attention's policy branch: qkv, the fp32 logits, softmax_with_policy,
    the value product in bf16, proj), forward and backward in bf16 as amp
    runs it, at B x 197 with 0.7 of the patches kept: ms by CUDA events."""
    gen = torch.Generator().manual_seed(12)
    attn = layers.Attention(D, HEADS).to(DEVICE, torch.bfloat16)
    x = torch.randn(B, 197, D, generator=gen).to(DEVICE, torch.bfloat16) \
        .requires_grad_()
    keep = (torch.rand(B, 196, 1, generator=gen) < 0.7).float()
    policy = torch.cat([torch.ones(B, 1, 1), keep], 1).to(DEVICE,
                                                        torch.bfloat16)
    dy = torch.randn(B, 197, D, generator=gen).to(DEVICE, torch.bfloat16)
    leaves = (x, *attn.parameters())

    def run():
        y, _ = attn(x, policy=policy)
        torch.autograd.grad(y, leaves, dy)

    return cuda_ms(run, runs=10)


def distill_breakdown(label: str, device_ms_step: float, by_kernel: dict,
                      teacher_ms: float | None):
    """Where a distillation step's device time goes: the teacher's forward
    (CUDA events in the counted run), DyViT's 12 policy attention halves
    (timed alone, policy_attention_ms), and the port's kernels (the
    profiled window's device time by kernel)."""
    own = sum(us for name, us in by_kernel.items()
              if name.startswith(PORT_KERNELS)) / 2e3
    parts = [f"the port's kernels {own:.2f} ms "
             f"({100 * own / device_ms_step:.1f}%)"]
    if teacher_ms is not None:
        parts.append(f"the teacher's forward {teacher_ms:.2f} ms "
                     f"({100 * teacher_ms / device_ms_step:.1f}%, events)")
    if label.startswith("dyvit"):
        policy = 12 * policy_attention_ms()
        parts.append(f"12 policy attention halves {policy:.2f} ms "
                     f"({100 * policy / device_ms_step:.1f}%, timed alone, "
                     "forward and backward)")
    print(f"phase 5 breakdown {label} bf16 amp b{TRAIN_B}: of "
          f"{device_ms_step:.2f} ms of device time a step: "
          + "; ".join(parts), flush=True)


def teacher_on_tensor_cores(by_kernel: dict):
    """The DyViT@0.7 distilled step's profile: the fp32 teacher's products
    and attention on the tensor-core kernels, and no fp32 backward GEMM
    (gemm_tf32_bwd_sm90_kernel, which only the fp32 training backward
    launches) in the step; phase_train holds the counts of its launchers
    (gemm_bwd_tf32, gemm_wgrad_tf32) to 0 in the counted amp run."""
    bwd = sorted(n for n in by_kernel
                 if n.startswith("gemm_tf32_bwd_sm90_kernel"))
    tf32 = {k: sum(us for n, us in by_kernel.items() if n.startswith(k))
            for k in ("gemm_tf32_sm90_kernel", "short_attention_tf32_kernel")}
    require(not bwd and all(tf32.values()),
            f"dyvit@0.7 distill: fp32 backward GEMMs {bwd} in the step, the "
            f"tensor-core kernels' device time {tf32}")
    print("phase 5 teacher on the tensor cores: no fp32 backward GEMM in "
          "the DyViT@0.7 distilled step; " + ", ".join(
              f"{k} {us / 2e3:.2f} ms a step" for k, us in tf32.items()),
          flush=True)


# the port's own kernels (csrc/), by their names' prefixes
PORT_KERNELS = ("gemm_sm90_kernel", "gemm_tf32_sm90_kernel",
                "gemm_tf32_bwd_sm90_kernel",
                "short_attention",
                "attention_fwd_sm90", "attention_bwd_sm90", "layer_norm",
                "sum_partials", "head_mean_keys")


def kernel_family(name: str) -> str:
    """A profiler kernel name without its arguments; the port's kernels
    keep their template arguments (dtype and layout)."""
    name = name.replace("void ", "").replace("trk::(anonymous namespace)::",
                                             "")
    name = name.split("(")[0]
    own = ("gemm_tf32_bwd_sm90_kernel", "short_attention",
           "attention_fwd_sm90",
           "attention_bwd_sm90", "layer_norm", "sum_partials",
           "head_mean_keys")
    return name if name.startswith(own) else name.split("<")[0]


def phase_train(card: str) -> dict:
    """Phase 5: the train steps; the launch counts of this run go into the
    JSON record. Then the eager library composition's steps and, last,
    the profiled windows, whose launches are not counted."""
    reset_counts()
    step_ms, teacher_ms = {}, {}
    for label in TRAIN_CELLS:
        sums_before = _build.sum_partials_many.launches
        seconds, step_losses, _, extra = train_run(label, TRAIN_STEPS)
        # one sum launch in each branch backward: at most 2 a block
        sums = _build.sum_partials_many.launches - sums_before
        want = TRAIN_STEPS * sum(PER_TRAIN_STEP_BWD[label][k] for k in (
            "attend_branch_train", "mlp_branch"))
        require(sums == want <= 2 * 12 * TRAIN_STEPS,
                f"{label}: {sums} sum launches in {TRAIN_STEPS} steps, not "
                f"{want} (one a branch backward, at most 2 a block)")
        print(f"phase 5 sums {label}: {sums / TRAIN_STEPS:g} sum launches a "
              f"step ({sums / TRAIN_STEPS / 12:g} a block of 12)", flush=True)
        timed = seconds[2:]
        step_ms[label] = 1e3 * sum(timed) / len(timed)
        teacher = ""
        if "teacher_ms" in extra:
            teacher_ms[label] = extra["teacher_ms"]
            teacher = (f"; the teacher's forward {teacher_ms[label]:.2f} ms "
                       "a step (CUDA events)")
        TRAIN_IPS[label, "amp"] = TRAIN_B * len(timed) / sum(timed)
        print(f"phase 5 train {label} bf16 amp b{TRAIN_B}: "
              f"{step_ms[label]:.2f} ms/step, "
              f"{TRAIN_B * len(timed) / sum(timed):.1f} img/s over steps "
              f"3-{TRAIN_STEPS} (first step {seconds[0] * 1e3:.1f} ms); "
              f"peak memory allocated {extra['peak'] / 2**30:.2f} GiB (the "
              f"{TRAIN_STEPS} batches {TRAIN_STEPS * TRAIN_B * 3 * 224 * 224 * 4 / 2**30:.2f} GiB of it){teacher}; "
              f"losses {[round(v, 4) for v in step_losses.tolist()]} on "
              f"{card}", flush=True)
    got = counts()
    expected = {k: TRAIN_STEPS * sum(PER_TRAIN_STEP[label][k]
                                     for label in TRAIN_CELLS)
                for k in WRAPPERS}
    require(got == expected, f"train launches {got} != {expected}")
    require(all(got[k] for k in TRAIN_WRAPPERS),
            f"a kernel of the path never ran: {got}")
    got.update(launcher_counts())
    require(got["gemm"] > 0 and got["gemm_wgrad"] > 0,
            f"train gemm launches {launcher_counts()}")
    require(got["short_attention"] > 0 and got["short_attention_bwd"] > 0,
            f"train attention launches {launcher_counts()}")
    # fp32 only in the DyViT teacher's blocks: 4 products and an attention
    # each, on the tensor cores
    require(got["gemm_tf32"] == 4 * got["fused_full_block"] > 0
            and got["attention_tf32"] == got["fused_full_block"]
            and not any(got[k] for k in FP32_LAUNCHERS[2:]),
            f"train fp32 launches {launcher_counts()}, the teacher's blocks "
            f"{got['fused_full_block']}")
    # the LayerNorm backward: once in the backward of each training branch
    ln_bwd = TRAIN_STEPS * sum(PER_TRAIN_STEP_BWD[label][k]
                               for label in TRAIN_CELLS
                               for k in ("attend_branch_train", "mlp_branch"))
    require(got["layer_norm_bwd"] == got["sum_partials"] == ln_bwd
            and got["rect_attention"] == 0 and got["head_mean_keys"] == 0,
            f"train LN backward launches {got['layer_norm_bwd']} or sum "
            f"launches {got['sum_partials']} != {ln_bwd}, or rectangular "
            f"attention {got['rect_attention']} or head_mean_keys "
            f"{got['head_mean_keys']} != 0")
    print(f"phase 5 launches {got}", flush=True)

    kernels = (layers.attend_branch_train, layers.mlp_branch,
               layers.attention_core_train)
    layers.attend_branch_train = library_attention
    layers.mlp_branch = library_mlp
    layers.attention_core_train = library_core
    try:
        for label in TRAIN_MODELS:
            seconds, _, _, _ = train_run(label, TRAIN_STEPS)
            timed = seconds[2:]
            print(f"phase 5 train {label} bf16 amp b{TRAIN_B}, eager library "
                  f"composition: {1e3 * sum(timed) / len(timed):.2f} ms/step, "
                  f"{TRAIN_B * len(timed) / sum(timed):.1f} img/s over steps "
                  f"3-{TRAIN_STEPS}", flush=True)
    finally:
        (layers.attend_branch_train, layers.mlp_branch,
         layers.attention_core_train) = kernels

    for label in ("dense", "topk@0.7", "tome@0.7", "heuristic",
                  *DISTILL_TRAIN):
        _, _, prof, _ = train_run(label, 4, profile=True)
        if prof is None:
            print(f"phase 5 profile {label}: device time not measured (the "
                  "profiler saw no device events)", flush=True)
            continue
        busy, by_kernel = prof
        total = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
        # the profiler slows the host; the device time per step against
        # the step time measured above without it
        print(f"phase 5 profile {label} bf16 amp b{TRAIN_B}: device busy "
              f"{100 * busy:.1f}% of two steps (torch.profiler); device time "
              f"{total / 2e3:.2f} ms per step, "
              f"{100 * total / 2e3 / step_ms[label]:.1f}% "
              f"of the unprofiled {step_ms[label]:.2f} ms/step; device time "
              f"by kernel: " + "; ".join(
                  f"{name} {100 * us / total:.1f}%" for name, us in top),
              flush=True)
        if label == "dyvit@0.7 distill":
            teacher_on_tensor_cores(by_kernel)
        if label in DISTILL_TRAIN:
            distill_breakdown(label, total / 2e3, by_kernel,
                              teacher_ms.get(label))
    got.update(fp32_train(card))
    return got


# the JAX CLI's default precision: a train step in fp32 (phase 5), and its
# launches a step: the attention backward once and the backward GEMM's
# layouts four times (dY . W, weight gradients) in each of the 12 branch
# backwards, the forward's products and attention, all on the tensor cores
FP32_TRAIN = "topk@0.7"
FP32_TRAIN_STEP = dict(attention_bwd_tf32=12, gemm_bwd_tf32=48,
                       gemm_wgrad_tf32=48, gemm_tf32=48, attention_tf32=12)


def fp32_train(card: str) -> dict:
    """Phase 5, last: FP32_TRAIN's train step in fp32 (bench.py's recipe
    without amp), a path of its own: the counts set to 0 just before and
    read just after; FP32_TRAIN_STEP's launches a step and no bf16 or
    rectangular launch required. Then a torch.profiler window of two more
    steps, uncounted: the device's time by kernel. Returns the launch
    counts of its fp32 backward's launchers."""
    reset_counts()
    seconds, step_losses, _, extra = train_run(FP32_TRAIN, TRAIN_STEPS,
                                               amp=False)
    got = launcher_counts()
    want = {k: TRAIN_STEPS * n for k, n in FP32_TRAIN_STEP.items()}
    require({k: got[k] for k in want} == want and not any(
        got[k] for k in ("gemm", "gemm_wgrad", "short_attention",
                         "short_attention_bwd", "rect_attention",
                         "rect_attention_tf32")),
            f"{FP32_TRAIN} fp32 train launches {got}, not {want}")
    timed = seconds[2:]
    TRAIN_IPS[FP32_TRAIN, "fp32"] = TRAIN_B * len(timed) / sum(timed)
    print(f"phase 5 train {FP32_TRAIN} fp32 b{TRAIN_B}: "
          f"{1e3 * sum(timed) / len(timed):.2f} ms/step, "
          f"{TRAIN_B * len(timed) / sum(timed):.1f} img/s over steps "
          f"3-{TRAIN_STEPS} (first step {seconds[0] * 1e3:.1f} ms); peak "
          f"memory allocated {extra['peak'] / 2**30:.2f} GiB; losses "
          f"{[round(v, 4) for v in step_losses.tolist()]}; launches a step "
          f"{ {k: got[k] / TRAIN_STEPS for k in want} } on {card}",
          flush=True)
    step_ms = 1e3 * sum(timed) / len(timed)
    _, _, prof, _ = train_run(FP32_TRAIN, 4, profile=True, amp=False)
    if prof is None:
        print(f"phase 5 profile {FP32_TRAIN} fp32: device time not measured "
              "(the profiler saw no device events)", flush=True)
    else:
        busy, by_kernel = prof
        total = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
        print(f"phase 5 profile {FP32_TRAIN} fp32 b{TRAIN_B}: device busy "
              f"{100 * busy:.1f}% of two steps (torch.profiler); device time "
              f"{total / 2e3:.2f} ms per step, "
              f"{100 * total / 2e3 / step_ms:.1f}% of the unprofiled "
              f"{step_ms:.2f} ms/step; device time by kernel: " + "; ".join(
                  f"{name} {100 * us / total:.1f}% ({us / 2e3:.2f} ms)"
                  for name, us in top), flush=True)
    return {k: got[k] for k in ("attention_bwd_tf32", "gemm_bwd_tf32",
                                "gemm_wgrad_tf32")}


def ptxas_lines(log: str):
    """(kernel, ptxas line) for each register and spill line of the build
    log, the kernel's name demangled where the toolkit's cu++filt (or
    c++filt) is found."""
    pairs, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            pairs.append((name, line.replace("ptxas info    :", "").strip()))
    names = sorted({n for n, _ in pairs})
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    plain = dict(zip(names, names))
    if tool and names:
        out = subprocess.run([tool], input="\n".join(names),
                             capture_output=True, text=True).stdout
        lines = out.splitlines()
        if len(lines) == len(names):
            plain = {n: line.replace("trk::<unnamed>::", "").replace(
                "trk::(anonymous namespace)::", "")
                for n, line in zip(names, lines)}
    return [(plain[n], line) for n, line in pairs]


# the fp32 kernels on the tensor cores, by their names' prefixes
TF32_KERNELS = ("gemm_tf32_sm90_kernel", "gemm_tf32_bwd_sm90_kernel",
                "short_attention_tf32_kernel",
                "short_attention_bwd_tf32_kernel",
                "attention_wide_tf32_kernel", "attention_wide_tf32_bwd_dq",
                "attention_wide_tf32_bwd_dkv")
# a TF32 product on the tensor cores in SASS: wgmma (HGMMA) or mma.sync
# (HMMA) with TF32 operands
TF32_MMA = re.compile(r"\bH(?:G)?MMA\.\S*TF32[^;]*")


def tf32_sass(path: pathlib.Path) -> dict:
    """{variant's mangled name: its first TF32 MMA instruction} for every
    variant of TF32_KERNELS in the built library (cuobjdump -sass, beside
    nvcc); fails if a variant has none, or a kernel has no variant."""
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1) if any(k in head.group(1)
                                      for k in TF32_KERNELS) else None
            if fn:
                found.setdefault(fn, None)
        elif fn and found[fn] is None and TF32_MMA.search(line):
            found[fn] = TF32_MMA.search(line).group(0).strip()
    for k in TF32_KERNELS:
        require(any(k in fn for fn in found), f"{k}: not in the library")
    require(all(found.values()), "no TF32 tensor-core instruction in "
            f"{[fn for fn, line in found.items() if line is None]}")
    return found


# validate's default precision: fp32 eval forwards at b256 (phase 4, after
# the counted serve run), each a path of its own: its counts set to 0 just
# before and read just after. A forward's fp32 launches: dense and
# topk@0.7 48 gemm_tf32 and 12 square attentions; ATS@0.7 the same GEMMs,
# 9 square attentions (its masked blocks) and 3 rectangular ones (its
# sampling blocks)
FP32_EVAL = {
    "dense": dict(gemm_tf32=48, attention_tf32=12, rect_attention_tf32=0),
    "topk@0.7": dict(gemm_tf32=48, attention_tf32=12, rect_attention_tf32=0),
    "ats@0.7": dict(gemm_tf32=48, attention_tf32=9, rect_attention_tf32=3)}


def phase_fp32_eval(card: str) -> dict:
    """Phase 4: SERVE_BATCHES batches of SERVE_B fp32 images through each
    FP32_EVAL model (JAX's validate runs fp32 unless --use_amp is given):
    finite logits, img/s over batches 2-5, and every product and attention
    of each forward on the tensor-core kernels, as FP32_EVAL counts them,
    and no other launcher. Returns ATS@0.7's run's launch counts."""
    for label, per_forward in FP32_EVAL.items():
        settle()
        name, kw = MODELS[label]
        model, _ = create_model(name, device=DEVICE,
                                generator=torch.Generator().manual_seed(1),
                                **kw)
        model = model.eval()
        xs = images(SERVE_BATCHES * SERVE_B,
                    torch.Generator().manual_seed(3)) \
            .view(SERVE_BATCHES, SERVE_B, 3, 224, 224)
        reset_counts()
        seconds = []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                out = model(x)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                require(out.shape == (SERVE_B, 1000) and
                        bool(torch.isfinite(out).all()),
                        f"{label}: non-finite or misshapen fp32 logits")
        got = launcher_counts()
        want = {k: SERVE_BATCHES * per_forward.get(k, 0) for k in got
                if k != "layer_norm"}
        require({k: got[k] for k in want} == want,
                f"{label} fp32: launches {got}, not {want}")
        ips = SERVE_B * (SERVE_BATCHES - 1) / sum(seconds[1:])
        FORWARD_IPS[label, "fp32"] = ips
        print(f"phase 4 serve {label} fp32 b{SERVE_B}: {ips:.1f} img/s over "
              f"batches 2-{SERVE_BATCHES} (first batch "
              f"{seconds[0] * 1e3:.1f} ms), launches "
              f"{ {k: n for k, n in got.items() if n} } on {card}",
              flush=True)
        del model, xs
    return got


# ---- phase 6: the eval and artifact contract, as users run it
# run name -> the MODELS label of its checkpoint (seeded DeiT-S weights)
EVAL_RUNS = {"deit_s": "dense", "topk_07": "topk@0.7", "evit_07": "evit@0.7",
             "tome_07": "tome@0.7", "dpcknn_07": "dpcknn@0.7",
             "heuristic": "heuristic"}
EVAL_N, EVAL_B, EVAL_CPU_N, EVAL_SIZE = 512, 256, 16, 224
# the share of DPC-KNN's chained decisions equal to the CPU's (phase 3's)
EVAL_DPCKNN_SAME = CLUSTER_FP32_SAME
# topk's and EViT's kept ids may differ from the CPU's only where the CPU's
# CLS-attention scores of the two tokens tie within this share of the
# stage's max score (as phase 3's soft assignments, SOFT_TIE): the card's
# plain fp32 composition and the CPU's sum in different orders, and a
# near-tie swaps two neighbours of the descending order
EVAL_SCORE_TIE = SOFT_TIE


def host_libraries() -> dict:
    """{"PIL": version or None, "pandas": version or None}."""
    found = {}
    for name in ("PIL", "pandas"):
        try:
            found[name] = __import__(name).__version__
        except ImportError:
            found[name] = None
    return found


def numpy_source(seed: int):
    """A validate/extract ``source`` without the Loader (no Pillow): numpy
    batches of normalised HWC float32 images, image i drawn from
    default_rng((seed, i)) (so a shorter run sees the same first images),
    with the synthetic set's names."""
    import numpy as np

    def source(args, num_classes):
        n, b, s = args.synthetic_n, args.batch_size, args.input_size

        def batches():
            for lo in range(0, n, b):
                rngs = [np.random.default_rng((seed, i))
                        for i in range(lo, min(lo + b, n))]
                yield {"image": np.stack([r.standard_normal(
                           (s, s, 3), dtype=np.float32) for r in rngs]),
                       "label": np.asarray([r.integers(num_classes)
                                            for r in rngs], np.int32),
                       "valid": len(rngs)}

        return batches(), lambda i: f"synthetic_{i:08d}.JPEG", False

    return source


def write_eval_checkpoints(runs: pathlib.Path):
    """<runs>/<run>/best_checkpoint/{meta.json, tree.pt} of each EVAL_RUNS
    model at DeiT-S's full width, its weights from a seeded generator."""
    from tokenreduction_tpu_torch.utils.checkpoint import save_checkpoint

    shutil.rmtree(runs, ignore_errors=True)
    for seed, (run, label) in enumerate(EVAL_RUNS.items()):
        name, kw = MODELS[label]
        model, cfg = create_model(name, device="cpu",
                                  generator=torch.Generator().manual_seed(
                                      20 + seed), **kw)
        save_checkpoint(str(runs / run / "best_checkpoint"),
                        params=model.state_dict(), model_cfg=cfg,
                        run_args={"model": name})


def write_overview(runs: pathlib.Path, csv_path: pathlib.Path,
                   pandas: bool):
    """The run-overview CSV: run_table's scan, or without pandas the
    columns the drivers read (Name, model, output_dir) from each
    checkpoint's meta.json by the csv module."""
    if pandas:
        from tokenreduction_tpu_torch.evaluation import run_table

        run_table.main(["--scan_root", str(runs), "--output", str(csv_path)])
        return
    import csv

    with open(csv_path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["Name", "model", "output_dir"])
        for run in sorted(EVAL_RUNS):
            meta = json.loads((runs / run / "best_checkpoint" /
                               "meta.json").read_text())
            out.writerow([run, meta["run_args"]["model"], runs / run])


class EvalRuns:
    """Wraps a CLI module's ``main`` (validate's or extract's) so that each
    run it makes is a path of its own: its counts set to 0 just before and
    read just after, its host time end to end (checkpoint load, data path
    and all) and the time of its synchronised forwards (the module's
    ``forward``) recorded by its checkpoint's run name."""

    def __init__(self, module, viz: bool = False):
        self.module, self.viz = module, viz  # viz: every run is a viz run
        self.main, self.forward = module.main, module.forward
        self.runs = {}

    def __enter__(self):
        def forward(*args, **kw):
            t0 = time.perf_counter()
            out = self.forward(*args, **kw)
            torch.cuda.synchronize()
            self.current["forward_s"] += time.perf_counter() - t0
            return out

        def main(argv, source=None):
            run = pathlib.Path(argv[argv.index("--checkpoint") + 1]).name
            self.current = dict(forward_s=0.0,
                                viz=self.viz or "--viz_mode" in argv)
            reset_counts()
            t0 = time.perf_counter()
            out = self.main(argv, source)
            torch.cuda.synchronize()
            self.current["seconds"] = time.perf_counter() - t0
            self.current["counts"] = {**counts(), **launcher_counts()}
            self.runs[run] = self.current
            return out

        self.module.main, self.module.forward = main, forward
        return self

    def __exit__(self, *exc):
        self.module.main, self.module.forward = self.main, self.forward


def eval_launches(label: str, rec: dict) -> str:
    """Require a fp32 non-viz run on the tensor-core kernels (no bf16
    launch) or a viz run with no launch at all; returns the counts."""
    got = {k: n for k, n in rec["counts"].items() if n}
    if rec["viz"]:
        require(not got, f"phase 6 {label} viz: launches {got}")
    else:
        require(rec["counts"]["gemm_tf32"] > 0
                and rec["counts"]["attention_tf32"] > 0
                and rec["counts"]["gemm"] == 0
                and rec["counts"]["short_attention"] == 0,
                f"phase 6 {label} fp32: launches {got}")
    return str(got)


def decisions_same(got: dict, want: dict, images: list):
    """Entries of the Stage-* decisions (Kept_Token, Assignment_Maps) equal
    in place between two viz JSONs, over ``images``: (equal, all, the
    first differing entries as text)."""
    n_same = n_all = 0
    differ = []
    for key in images:
        for stage, entry in want[key].items():
            if not stage.startswith("Stage-"):
                continue
            for field, w in entry.items():
                g = got[key][stage][field]
                require(len(g) == len(w), f"{key} {stage} {field}: "
                        f"{len(g)} entries, on the CPU {len(w)}")
                same = [a == b for a, b in zip(g, w)]
                n_same += sum(same)
                n_all += len(w)
                if not all(same) and len(differ) < 4:
                    at = [i for i, s in enumerate(same) if not s]
                    differ.append(f"{key} {stage} {field} at {at[:8]}: "
                                  f"card {[g[i] for i in at[:8]]}, CPU "
                                  f"{[w[i] for i in at[:8]]}")
    return n_same, n_all, differ


class ScoreRecord:
    """Wraps validate's ``load_eval_model`` so that the models it builds
    record each reduction block's CLS-attention score (topk's and EViT's
    ranking), the last batch's, on the host: {block: [B, patches]}."""

    def __init__(self, V):
        self.v, self.load, self.scores = V, V.load_eval_model, {}

    def __enter__(self):
        def load(*args, **kw):
            model, *rest = self.load(*args, **kw)
            for i in model.cfg.reduction_loc:
                blk = model.blocks[i]

                def attend(x, *a, i=i, inner=blk.attend, **k):
                    out = inner(x, *a, **k)
                    if k.get("score") == "cls":
                        self.scores[i] = out[1][0].float().cpu()
                    return out

                blk.attend = attend
            return (model, *rest)

        self.v.load_eval_model = load
        return self

    def __exit__(self, *exc):
        self.v.load_eval_model = self.load


def score_ties(got: dict, want: dict, scores: dict, images: list, loc):
    """Of the card's chained Kept_Token entries that differ from the
    CPU's, over ``images`` (the CPU run's batch, in order): (ties, others,
    the widest tie's gap as a share of its stage's max score). A tie: the
    CPU's scores of the two tokens at that stage (ids local to the CPU's
    previous stage) differ by at most EVAL_SCORE_TIE of the stage's max
    score."""
    ties = others = 0
    widest = 0.0
    for n, key in enumerate(images):
        prev = None
        for blk in loc:
            stage = f"Stage-{blk}"
            g = got[key][stage]["Kept_Token"]
            w = want[key][stage]["Kept_Token"]
            score = scores[blk][n]
            tol = EVAL_SCORE_TIE * float(score.abs().max())
            for a, b in zip(g, w):
                if a == b:
                    continue
                ids = [a, b] if prev is None else \
                    [prev.index(v) if v in prev else None for v in (a, b)]
                gap = None if None in ids else abs(float(
                    score[ids[0]] - score[ids[1]]))
                if gap is not None and gap <= tol:
                    ties += 1
                    widest = max(widest, gap / float(score.abs().max()))
                else:
                    others += 1
            prev = w
    return ties, others, widest


def phase_eval(card: str) -> dict:
    """Phase 6 (see the module docstring). Returns the launch counts of its
    runs, summed, for the kernels' record."""
    import numpy as np

    from tokenreduction_tpu_torch.evaluation import (
        extract_cls_features as E,
        extract_cls_features_dirs,
        validate as V,
        validate_dirs,
    )

    libs = host_libraries()
    print(f"phase 6 host libraries: "
          f"{', '.join(f'{k} {v or 'absent'}' for k, v in libs.items())}; "
          f"host path: {'the Loader' if libs['PIL'] else 'numpy batches'} "
          f"and {'run_table' if libs['pandas'] else 'the csv module'}",
          flush=True)
    source = None if libs["PIL"] else numpy_source(5)
    root = pathlib.Path(__file__).resolve().parent / "build" / "phase6"
    runs, out = root / "runs", root / "out"
    shutil.rmtree(root, ignore_errors=True)
    write_eval_checkpoints(runs)
    csv_path = root / "overview.csv"
    write_overview(runs, csv_path, bool(libs["pandas"]))
    data = ["--dataset", "synthetic", "--synthetic-n", str(EVAL_N), "-b",
            str(EVAL_B), "--input-size", str(EVAL_SIZE)]
    dirs = data + ["--csv", str(csv_path)]
    total = dict.fromkeys([*WRAPPERS, *LAUNCHERS], 0)

    def add(recs):
        for rec in recs.values():
            for k, n in rec["counts"].items():
                total[k] += n

    with EvalRuns(V) as fp32:
        validate_dirs.main(dirs + ["--no-viz_mode", "--output_dir",
                                   str(out / "fp32")], source)
    with EvalRuns(V) as amp:
        V.main(data + ["--use_amp", "--checkpoint", str(runs / "topk_07"),
                       "--output_dir", str(out / "amp")], source)
    with EvalRuns(V) as viz:
        validate_dirs.main(dirs + ["--output_dir", str(out / "viz")], source)
    # validate_dirs runs deit rows without viz; the dense model's viz run
    # (the plain composition, no viz data) by validate itself
    with EvalRuns(V) as dense_viz:
        V.main(data + ["--viz_mode", "--checkpoint", str(runs / "deit_s"),
                       "--output_dir", str(out / "dense_viz"),
                       "--viz_output_name", "deit_s_viz_results.json"],
               source)
    with EvalRuns(E, viz=True) as ext:
        extract_cls_features_dirs.main(dirs + ["--output_dir",
                                               str(out / "npy")], source)
    # the viz pass's dense row runs without viz: the fp32 kernels
    eval_launches("deit_s", viz.runs["deit_s"])
    for recs, want in ((fp32, EVAL_RUNS), (amp, ["topk_07"]),
                       (viz, EVAL_RUNS), (dense_viz, ["deit_s"]),
                       (ext, EVAL_RUNS)):
        require(sorted(recs.runs) == sorted(want),
                f"phase 6: runs {sorted(recs.runs)}, not {sorted(want)}")
        add(recs.runs)

    # bf16: the counterparts' launches of two batches, as phase 4 counts a
    # topk@0.7 forward, on the bf16 GEMM and attention
    rec = amp.runs["topk_07"]
    batches = -(-EVAL_N // EVAL_B)
    want = {k: batches * n for k, n in PER_FORWARD["topk@0.7"].items()}
    require({k: rec["counts"][k] for k in want} == want
            and rec["counts"]["gemm"] > 0
            and rec["counts"]["short_attention"] > 0
            and not any(rec["counts"][k] for k in FP32_LAUNCHERS),
            f"phase 6 topk_07 --use_amp: launches {rec['counts']}")
    amp_json = json.loads((out / "amp" / "viz_results.json").read_text())
    require(all(np.isfinite(amp_json[k]["Loss"]) for k in amp_json
                if k.startswith("synthetic_")),
            "phase 6 topk_07 --use_amp: a non-finite loss")
    print(f"phase 6 validate topk_07 --use_amp b{EVAL_B}: "
          f"{EVAL_N / rec['seconds']:.1f} img/s end to end, "
          f"{EVAL_N / rec['forward_s']:.1f} forward only (its batches' "
          f"copies to the card included); Acc@1 "
          f"{amp_json['Top1-Acc']}; launches "
          f"{ {k: n for k, n in rec['counts'].items() if n} } on {card}",
          flush=True)

    cpu = root / "cpu"
    for run, label in EVAL_RUNS.items():
        name = f"{run}_viz_results.json"
        nonviz = json.loads((out / "fp32" / name).read_text())
        vizj = json.loads((out / "viz" / name).read_text())
        images = [k for k in nonviz if k.startswith("synthetic_")]
        require(len(images) == EVAL_N and list(vizj) == list(nonviz),
                f"phase 6 {run}: {len(images)} images, keys differ "
                f"{list(vizj) != list(nonviz)}")
        if run == "deit_s":
            vizj = json.loads((out / "dense_viz" / name).read_text())
        worst = max(abs(vizj[k]["Loss"] - nonviz[k]["Loss"]) /
                    abs(nonviz[k]["Loss"]) for k in images)
        differ = [k for k in images
                  if vizj[k]["Predictions"] != nonviz[k]["Predictions"]]
        require(not differ and worst <= 1e-4,
                f"phase 6 {run}: fp32 predictions differ from the plain "
                f"viz run's in {len(differ)} images, losses {worst:.2e} "
                "relative")
        same = (f"predictions equal to the viz run's, losses within "
                f"{worst:.2e} relative; ")
        for b in E.EXTRACT_BLOCKS:
            feats = np.load(out / "npy" / f"{run}_cls_features_{b}.npy")
            require(feats.shape == (D, EVAL_N) and feats.dtype == np.float32
                    and np.isfinite(feats).all(),
                    f"phase 6 {run}: block {b} features {feats.shape} "
                    f"{feats.dtype}")

        # the CPU's viz run and extraction of the first EVAL_CPU_N images
        cpu_data = ["--dataset", "synthetic", "--synthetic-n",
                    str(EVAL_CPU_N), "-b", str(EVAL_CPU_N), "--input-size",
                    str(EVAL_SIZE), "--device", "cpu", "--checkpoint",
                    str(runs / run)]
        report = same
        if run != "deit_s":
            with ScoreRecord(V) as scored:
                V.main(cpu_data + ["--viz_mode", "--output_dir", str(cpu),
                                   "--viz_output_name", name], source)
            cpu_json = json.loads((cpu / name).read_text())
            first = [k for k in cpu_json if k.startswith("synthetic_")]
            require(first == images[:EVAL_CPU_N],
                    f"phase 6 {run}: CPU images {first[:2]}...")
            n_same, n_all, differ = decisions_same(vizj, cpu_json, first)
            report += f"decisions equal to the CPU's {n_same}/{n_all}"
            if label in ("topk@0.7", "evit@0.7"):
                ties, others, widest = score_ties(
                    vizj, cpu_json, scored.scores, first,
                    MODELS[label][1]["reduction_loc"])
                require(n_all > 0 and others == 0,
                        f"phase 6 {run}: {others} kept ids differ from the "
                        f"CPU's where its scores do not tie (and {ties} "
                        f"ties); {'; '.join(differ)}")
                report += (f", the other {ties} ties of the CPU's scores "
                           f"(gaps within {widest:.2e} of the stage's max, "
                           f"bound {EVAL_SCORE_TIE:.0e})"
                           f"{': ' + '; '.join(differ) if ties else ''}")
            else:
                least = EVAL_DPCKNN_SAME if label == "dpcknn@0.7" else 1.0
                require(n_all > 0 and n_same >= least * n_all,
                        f"phase 6 {run}: {n_same}/{n_all} decisions equal "
                        f"to the CPU's (bound {least}); {'; '.join(differ)}")
                report += f" (bound {least})"
            report += "; "
        cpu_feats = E.main(cpu_data + ["--output_dir", str(cpu),
                                       "--feature_output_name",
                                       f"{run}_cls_features"], source)
        worst = 0.0
        for b in E.EXTRACT_BLOCKS:
            card_feats = np.load(out / "npy" /
                                 f"{run}_cls_features_{b}.npy")[:, :EVAL_CPU_N]
            err = float(np.abs(card_feats - cpu_feats[b]).max() /
                        np.abs(cpu_feats[b]).max())
            worst = max(worst, err)
        require(worst <= 1e-4, f"phase 6 {run}: features {worst:.2e} of "
                "max|CPU| from the CPU's")
        report += f"features within {worst:.2e} of max|CPU|"

        rec, erec = fp32.runs[run], ext.runs[run]
        vrec = (dense_viz if run == "deit_s" else viz).runs[run]
        phase4 = "; ".join(f"{tag} {FORWARD_IPS[label, tag]:.1f}"
                           for tag in ("fp32", "bf16")
                           if (label, tag) in FORWARD_IPS)
        print(f"phase 6 eval {run} b{EVAL_B} fp32: validate "
              f"{EVAL_N / rec['seconds']:.1f} img/s end to end, "
              f"{EVAL_N / rec['forward_s']:.1f} forward only (copies to "
              f"the card included), launches "
              f"{eval_launches(run, rec)}; viz validate "
              f"{EVAL_N / vrec['seconds']:.1f} img/s, launches "
              f"{eval_launches(run, vrec)}; extract "
              f"{EVAL_N / erec['seconds']:.1f} img/s, launches "
              f"{eval_launches(run, erec)}; phase 4 forward-only img/s "
              f"{phase4 or 'not measured'}; Acc@1 {nonviz['Top1-Acc']}, "
              f"Params {nonviz['Params']}M; {report}; on {card}",
              flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return total


# phase 7: the train CLI at DeiT-S's full width (topk@0.7 at loc 3 6 9,
# 224 px, the synthetic set): the default recipe (mixup 0.8, cutmix 1.0,
# label smoothing 0.1, drop-path 0.1, EMA) in amp and in fp32 (the JAX
# CLI's default), b256 over 512 images (RASampler: 2 steps an epoch: few
# enough for the script's time limit with phase 12), two epochs, then
# --resume for a third
CLI_MODEL = ["--model", "topk_small_patch16_224", "--reduction_loc", "3",
             "6", "9", "--keep_rate", "0.7", "--input-size", "224",
             "--dataset", "synthetic", "--print-freq", "100"]
CLI_N, CLI_B, CLI_EPOCHS = 512, 256, 2
# the card against the CPU: b16 over 32 images (--no-repeated-aug: 2
# steps), fp32, drop-path 0, mixup and cutmix on, one epoch, from one
# .pth; the first step's loss and the epoch's test loss within this
# relative bound
CLI_CPU_N, CLI_CPU_B, CLI_CPU_BOUND = 32, 16, 1e-4
# validate's run on the trained checkpoint: one batch
CLI_VALIDATE_N = 256
# phase 7's train img/s an epoch (log.txt) by "amp" or "fp32", printed
# beside phase 8's --device_aug runs
CLI_IPS = {}


def cli_workers() -> int:
    """The worker processes of the CLI runs' Loaders: the cores this process may use, less one for
    the main thread, at most 8."""
    import os

    return max(1, min(8, len(os.sched_getaffinity(0)) - 1))


class CliRun:
    """Wraps one train CLI run (``train_cli.main``) as a path of its own:
    the counts set to 0 just before and read just after; the host time of
    the evals in the loop (``loop.evaluate``, which ends reading its sums),
    of ``AsyncCheckpointer.save`` on the main thread and of the background
    writes (``save_checkpoint``); the loss tensor of every train step (the
    loop's ``make_train_step``'s step), read after the run."""

    def __init__(self):
        from tokenreduction_tpu_torch.utils import checkpoint

        self.ckpt = checkpoint
        self.orig = (train_loop.evaluate, train_loop.make_train_step,
                     checkpoint.AsyncCheckpointer.save,
                     checkpoint.save_checkpoint)
        self.eval_s, self.save_s, self.write_s = [], [], []
        self.losses = []

    def __enter__(self):
        evaluate, make_step, save, write = self.orig

        def timed(fn, into):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                into.append(time.perf_counter() - t0)
                return out
            return run

        def make_train_step(*a, **kw):
            train_step = make_step(*a, **kw)

            def recorded(state, batch):
                state, metrics = train_step(state, batch)
                self.losses.append(metrics["loss"])
                return state, metrics
            return recorded

        train_loop.evaluate = timed(evaluate, self.eval_s)
        train_loop.make_train_step = make_train_step
        self.ckpt.AsyncCheckpointer.save = timed(save, self.save_s)
        self.ckpt.save_checkpoint = timed(write, self.write_s)
        reset_counts()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.counts = {**counts(), **launcher_counts()}
        (train_loop.evaluate, train_loop.make_train_step,
         self.ckpt.AsyncCheckpointer.save, self.ckpt.save_checkpoint) = \
            self.orig


def read_log(run: pathlib.Path) -> list:
    return [json.loads(line) for line in
            (run / "log.txt").read_text().splitlines()]


def cli_run(argv: list):
    """One train CLI run under CliRun; returns the CliRun."""
    from tokenreduction_tpu_torch.train import train_cli

    with CliRun() as rec:
        train_cli.main(argv)
    return rec


def cli_train_launches(label: str, rec: CliRun, steps: int, forwards: int,
                       amp: bool, phase: str = "7") -> dict:
    """Require #9 and #10 as phase 5 counts them a step (a forward and a
    backward each, 12 blocks) times the steps, the eval forwards' eval
    counterparts as phase 4 counts a topk@0.7 forward times the forwards,
    those on the fp32 tensor-core kernels (gemm_tf32, attention_tf32),
    and the training products on the bf16 GEMM (amp) or the fp32 backward
    GEMMs (fp32). Returns the non-zero counts."""
    c = rec.counts
    want = {k: steps * n for k, n in PER_TRAIN_STEP["topk@0.7"].items()
            if k in TRAIN_WRAPPERS}
    want.update({k: forwards * n for k, n in PER_FORWARD["topk@0.7"].items()
                 if k in EVAL_WRAPPERS})
    require({k: c[k] for k in want} == want and want["attend_branch_train"]
            and want["mlp_branch"],
            f"phase {phase} {label}: launches {c}, not {want}")
    require(c["gemm_tf32"] > 0 and c["attention_tf32"] > 0,
            f"phase {phase} {label}: the fp32 eval launched no tensor-core "
            f"kernel "
            f"{c}")
    if amp:
        require(c["gemm"] > 0 and c["short_attention_bwd"] > 0
                and c["gemm_bwd_tf32"] == 0,
                f"phase {phase} {label}: amp training launches {c}")
    else:
        require(c["gemm"] == 0 and c["gemm_bwd_tf32"] == 48 * steps
                and c["attention_bwd_tf32"] == 12 * steps,
                f"phase {phase} {label}: fp32 training launches {c}")
    return {k: n for k, n in c.items() if n}


def cli_recipe(label: str, amp: bool, root: pathlib.Path, total: dict,
               card: str, resume_workers: int = 0):
    """The default recipe's two epochs with the CLI's default Loader (one
    prefetch thread), then the resumed third with ``resume_workers``
    worker processes, each run a path of its own; returns the first run's
    directory."""
    run, resumed = root / label, root / f"{label} resumed"
    base = CLI_MODEL + ["--batch-size", str(CLI_B), "--synthetic-n",
                        str(CLI_N), "--save_more_than_best"] + (
                            ["--use_amp"] if amp else [])
    steps_per_epoch = CLI_N // CLI_B
    forwards = 2 * -(-CLI_N // CLI_B)  # the params' and the EMA's evals
    for what, argv, epochs, workers in (
            ("", ["--epochs", str(CLI_EPOCHS), "--output_dir", str(run)],
             range(CLI_EPOCHS), 0),
            (" resumed", ["--epochs", str(CLI_EPOCHS + 1), "--output_dir",
                          str(resumed), "--resume",
                          str(run / "checkpoint")], [CLI_EPOCHS],
             resume_workers)):
        argv = argv + ["--num-workers", str(workers)]
        t0 = time.perf_counter()
        rec = cli_run(base + argv)
        seconds = time.perf_counter() - t0
        out = run if not what else resumed
        rows = read_log(out)
        require([r["epoch"] for r in rows] == list(epochs),
                f"phase 7 {label}{what}: epochs {[r['epoch'] for r in rows]}"
                f", not {list(epochs)}")
        losses = torch.stack(rec.losses).cpu()
        require(bool(torch.isfinite(losses).all()) and all(
            math.isfinite(r[k]) for r in rows
            for k in ("train_loss", "test_loss")),
            f"phase 7 {label}{what}: losses {losses.tolist()}, rows {rows}")
        for f in ("tree.pt", "meta.json"):
            require((out / "best_checkpoint" / f).is_file(),
                    f"phase 7 {label}{what}: no best_checkpoint/{f}")
        got = cli_train_launches(f"{label}{what}", rec,
                                 steps_per_epoch * len(epochs),
                                 forwards * len(epochs), amp)
        for k, n in rec.counts.items():
            total[k] += n
        phase5 = TRAIN_IPS.get(("topk@0.7", "amp" if amp else "fp32"))
        if not what:
            CLI_IPS[label] = [r["images_per_sec"] for r in rows]
        print(f"phase 7 train CLI {label}{what} b{CLI_B}: epochs "
              f"{list(epochs)}, {seconds:.1f} s the run; train img/s end to "
              f"end (log.txt images_per_sec) "
              f"{[round(r['images_per_sec'], 1) for r in rows]} beside phase "
              f"5's step {phase5 or 0:.1f} img/s; epoch seconds "
              f"{[round(r['epoch_time'], 2) for r in rows]}; eval "
              f"{sum(rec.eval_s):.2f} s in {len(rec.eval_s)} evals "
              f"({[round(s, 2) for s in rec.eval_s]}); checkpoint save() "
              f"on the main thread {sum(rec.save_s):.3f} s in "
              f"{len(rec.save_s)} saves, background writes "
              f"{[round(s, 2) for s in rec.write_s]} s; losses "
              f"{[round(v, 4) for v in losses.tolist()]}; test loss "
              f"{[round(r['test_loss'], 4) for r in rows]}, acc1 "
              f"{[r['test_acc1'] for r in rows]}; Loader "
              f"{f'{workers} worker processes' if workers else 'thread'}; "
              f"launches {got} on {card}", flush=True)
    return run


def cli_validate(run: pathlib.Path, total: dict, card: str):
    """The train -> validate chain: the port's validate on the card reads
    the run's best_checkpoint (fp32, the tensor-core kernels)."""
    from tokenreduction_tpu_torch.evaluation import validate

    reset_counts()
    t0 = time.perf_counter()
    data = validate.main(["--checkpoint", str(run), "--dataset", "synthetic",
                          "--synthetic-n", str(CLI_VALIDATE_N), "-b",
                          str(CLI_B), "--input-size", "224"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = {**counts(), **launcher_counts()}
    for k, n in got.items():
        total[k] += n
    losses = [v["Loss"] for k, v in data.items()
              if k.startswith("synthetic_")]
    require(len(losses) == CLI_VALIDATE_N and all(
        math.isfinite(v) for v in losses) and got["gemm_tf32"] > 0
            and got["attention_tf32"] > 0 and got["gemm"] == 0,
            f"phase 7 validate {run.name}: {len(losses)} images, launches "
            f"{got}")
    print(f"phase 7 validate {run.name}/best_checkpoint: Acc@1 "
          f"{data['Top1-Acc']}, {CLI_VALIDATE_N / seconds:.1f} img/s end to "
          f"end; launches { {k: n for k, n in got.items() if n} } on {card}",
          flush=True)


def cli_against_cpu(root: pathlib.Path, card: str):
    """The card against the CPU (the port on both): one epoch at b16 over
    32 images, fp32, drop-path 0, mixup and cutmix on (the host draws
    from --seed), from one .pth of seeded weights."""
    pth = root / "finetune.pth"
    model, _ = create_model(MODELS["topk@0.7"][0], device="cpu",
                            generator=torch.Generator().manual_seed(31),
                            **MODELS["topk@0.7"][1])
    torch.save({"model": model.state_dict()}, pth)
    argv = CLI_MODEL + ["--batch-size", str(CLI_CPU_B), "--synthetic-n",
                        str(CLI_CPU_N), "--epochs", "1", "--drop-path", "0",
                        "--no-repeated-aug", "--finetune", str(pth)]
    from tokenreduction_tpu_torch.utils.checkpoint import load_checkpoint

    runs, params = {}, {}
    for device in ("cuda", "cpu"):
        out = root / f"against cpu {device}"
        rec = cli_run(argv + ["--device", device, "--output_dir", str(out)])
        runs[device] = (torch.stack(rec.losses).cpu(), read_log(out)[0])
        params[device] = load_checkpoint(str(out / "best_checkpoint"))[0][
            "params"]
    worst_name, worst = max(((n, rel_err(t, params["cpu"][n])[1])
                             for n, t in params["cuda"].items()),
                            key=lambda t: t[1])
    (card_losses, card_row), (cpu_losses, cpu_row) = runs["cuda"], \
        runs["cpu"]
    first = abs(card_losses[0] - cpu_losses[0]).item() / \
        abs(cpu_losses[0]).item()
    test = abs(card_row["test_loss"] - cpu_row["test_loss"]) / \
        abs(cpu_row["test_loss"])
    later = (card_losses[1:] - cpu_losses[1:]).abs() / cpu_losses[1:].abs()
    require(first <= CLI_CPU_BOUND and test <= CLI_CPU_BOUND,
            f"phase 7 card against CPU: first step's loss {first:.2e}, test "
            f"loss {test:.2e} relative > {CLI_CPU_BOUND:.0e}")
    print(f"phase 7 train CLI card against CPU fp32 b{CLI_CPU_B}, mixup and "
          f"cutmix on: first step's loss {card_losses[0].item():.6f} vs "
          f"{cpu_losses[0].item():.6f} ({first:.2e} rel, bound "
          f"{CLI_CPU_BOUND:.0e}); test loss {card_row['test_loss']:.6f} vs "
          f"{cpu_row['test_loss']:.6f} ({test:.2e} rel); later steps "
          f"{[f'{v:.2e}' for v in later.tolist()]} rel (reported); acc1 "
          f"{card_row['test_acc1']} vs {cpu_row['test_acc1']}; params after "
          f"the epoch: worst leaf {worst_name} {worst:.2e} of its max|CPU| "
          f"(reported) on {card}", flush=True)


def no_train_mode_check(card: str):
    """Repair 0.a on the card: one --no-train-mode step (the model in eval
    mode under autograd) of topk@0.7 at B=8 in fp32 launches no eval
    kernel and no training branch (the plain composition), and its loss
    and every gradient agree with the CPU's within phase 3's 1e-4 of each
    leaf's max|CPU|; the same eval forward under torch.no_grad() takes the
    kernels."""
    name, kw = MODELS["topk@0.7"]
    model, _ = create_model(name, device=DEVICE,
                            generator=torch.Generator().manual_seed(1), **kw)
    cpu_model = copy.deepcopy(model).cpu()
    gen = torch.Generator().manual_seed(2)
    B = MODEL_BATCH[torch.float32]
    x = images(B, gen)
    y = torch.randint(0, 1000, (B,), generator=gen).to(DEVICE)
    cfg = StepConfig(train_mode=False)
    opt, _ = create_optimizer(dict(model.named_parameters()), OptimConfig(),
                              lambda s: 1e-3, [])
    params = init_train_state(model, opt, device=DEVICE).params
    cpu_params = init_train_state(cpu_model, opt, device="cpu").params
    model.eval()
    cpu_model.eval()
    reset_counts()
    loss, grads = loss_and_grads(model, label_smoothing_loss, params, x, y,
                                 cfg)
    torch.cuda.synchronize()
    got = {**counts(), **launcher_counts()}
    require(not any(got.values()),
            f"phase 7 --no-train-mode: an eval-mode step launched {got}")
    cpu_loss, cpu_grads = loss_and_grads(cpu_model, label_smoothing_loss,
                                         cpu_params, x.cpu(), y.cpu(), cfg)
    _, loss_rel = rel_err(loss.cpu().reshape(1), cpu_loss.reshape(1))
    worst_name, worst = max(((n, rel_err(g.cpu(), cpu_grads[n])[1])
                             for n, g in grads.items()), key=lambda t: t[1])
    bound_ = TRAIN_BOUND[torch.float32]
    require(loss_rel <= bound_["loss"] and worst <= bound_["grads"],
            f"phase 7 --no-train-mode: loss {loss_rel:.2e}, gradient "
            f"{worst_name} {worst:.2e} of max|CPU|")
    with torch.no_grad():
        model(x)
    torch.cuda.synchronize()
    require(counts() == PER_FORWARD["topk@0.7"],
            f"phase 7 --no-train-mode: a no_grad eval forward launched "
            f"{counts()}")
    print(f"phase 7 --no-train-mode topk@0.7 fp32 B={B}: no kernel launch "
          f"in the step (the plain composition); loss {loss.item():.6f} vs "
          f"CPU {cpu_loss.item():.6f} ({loss_rel:.2e} rel); worst gradient "
          f"leaf {worst_name} {worst:.2e} of its max|CPU| (bound "
          f"{bound_['grads']:.0e}); the no_grad eval forward's launches "
          f"{ {k: n for k, n in counts().items() if n} } on {card}",
          flush=True)


def phase_cli(card: str) -> dict:
    """Phase 7 (see the module docstring). Returns the launch counts of its
    runs, summed, for the kernels' record."""
    root = pathlib.Path(__file__).resolve().parent / "build" / "phase7"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    total = dict.fromkeys([*WRAPPERS, *LAUNCHERS], 0)
    no_train_mode_check(card)
    amp_run = cli_recipe("amp", True, root, total, card, cli_workers())
    cli_recipe("fp32", False, root, total, card)
    cli_validate(amp_run, total, card)
    cli_against_cpu(root, card)
    shutil.rmtree(root, ignore_errors=True)
    return total


# phase 8: the rest of the train CLI's flags at DeiT-S's full width
AUG_B, AUG_SQUARE = 256, 256  # the aug's timed batch: b256 of 256-px squares
AUG_CHECK_B = 32  # the card against the CPU: two RandAugment groups
AUG_LEVELS = 1e-4 * 255  # the float transforms' bound, in levels
# the geometric ops: at most 1 level apart on at most this share of values
AUG_GEOMETRIC_SHARE = 1e-3
LOADER_N = 512  # images the Loader's ms a batch is timed over, each path
OPT_NAMES = ("sgd", "nesterov", "momentum", "adam", "adamw", "adabelief",
             "nadam", "radam", "adadelta", "adafactor", "rmsprop",
             "rmsproptf", "novograd", "nvnovograd", "adamp", "sgdp",
             "adahessian", "lookahead_adamw")
OPT_B, OPT_STEPS, OPT_BOUND, DIAG_BOUND = 32, 3, 1e-5, 1e-4
# the chains that add the weight decay to the gradient before Adam
# normalises it: where g + wd p cancels to a few ulps, the step
# g / (|g| + eps) is ill-conditioned, and fp32 on the CPU itself misses
# the fp64 result at 196-264 of the 22M params by up to 1.4e-3 of a
# leaf's max; likewise AdaHessian where the Hutchinson diagonal is near 0
# (6 params, up to 1.8e-5; measured on the CPU at these params). There
# at most this share of the params may miss OPT_BOUND, each within
# OPT_ILL_WORST of its leaf's max|CPU|
OPT_ILL = ("adam", "nadam", "adabelief", "adahessian")
OPT_ILL_SHARE, OPT_ILL_WORST = 1e-4, 1e-2
# the Hutchinson diagonal's batch: phase 3's fp32 batch (the CPU's double
# backward of DeiT-S sets the time)
DIAG_B = MODEL_BATCH[torch.float32]
NPZ_BOUND = 1e-4


def since(t0: float) -> str:
    return f"{time.perf_counter() - t0:.1f} s"


def aug_cli(label: str, amp: bool, root: pathlib.Path, total: dict,
            card: str):
    """The default recipe's two epochs with --device_aug (the Loader's one
    prefetch thread copies uint8 squares, the step augments them on the
    card), a path of its own; launches as phase 7's a step."""
    t0 = time.perf_counter()
    run = root / label
    rec = cli_run(CLI_MODEL + [
        "--batch-size", str(CLI_B), "--synthetic-n", str(CLI_N), "--epochs",
        str(CLI_EPOCHS), "--device_aug", "--output_dir", str(run)] + (
            ["--use_amp"] if amp else []))
    rows = read_log(run)
    steps = CLI_N // CLI_B * CLI_EPOCHS
    losses_ = torch.stack(rec.losses).cpu()
    require([r["epoch"] for r in rows] == list(range(CLI_EPOCHS))
            and bool(torch.isfinite(losses_).all())
            and all(math.isfinite(r["test_loss"]) for r in rows),
            f"phase 8 --device_aug {label}: rows {rows}")
    got = cli_train_launches(f"--device_aug {label}", rec, steps,
                             2 * -(-CLI_N // CLI_B) * CLI_EPOCHS, amp, "8")
    for k, n in rec.counts.items():
        total[k] += n
    per_step = {k: got[k] / steps for k in TRAIN_WRAPPERS if k in got}
    print(f"phase 8 train CLI --device_aug {label} b{CLI_B}: train img/s an "
          f"epoch (log.txt) "
          f"{[round(r['images_per_sec'], 1) for r in rows]} beside phase 7's "
          f"host path {[round(v, 1) for v in CLI_IPS.get(label, [])]}; "
          f"epoch seconds {[round(r['epoch_time'], 2) for r in rows]}; eval "
          f"{sum(rec.eval_s):.2f} s in {len(rec.eval_s)} evals; losses "
          f"{[round(v, 4) for v in losses_.tolist()]}; training branches' "
          f"launches a step {per_step}; "
          f"launches {got} on {card}; {since(t0)}", flush=True)


def loader_ms(transform, n: int) -> float:
    """ms a b256 batch of the Loader (one prefetch thread) over n synthetic
    images at 224 px with ``transform``."""
    from tokenreduction_tpu_torch.data import Loader, ShardedSampler
    from tokenreduction_tpu_torch.data.datasets import build_dataset

    ds, _ = build_dataset("", "synthetic", "train", num_classes=1000,
                          img_size=224, synthetic_n=n)
    loader = Loader(ds, ShardedSampler(n, 1, 0, seed=0), CLI_B, transform,
                    drop_last=True, seed=0)
    t0 = time.perf_counter()
    batches = sum(1 for _ in loader)
    return 1e3 * (time.perf_counter() - t0) / batches


def aug_times(card: str):
    """The aug's own ms for a b256 batch of 256-px squares (CUDA events)
    beside the Loader's ms a batch on the host path and on the uint8
    path."""
    t0 = time.perf_counter()
    from tokenreduction_tpu_torch.data import TransformConfig, make_transform
    from tokenreduction_tpu_torch.data.device_aug import (
        DeviceAugConfig, make_device_augment)
    from tokenreduction_tpu_torch.data.pipeline import make_raw_transform

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    x = torch.randint(0, 256, (AUG_B, AUG_SQUARE, AUG_SQUARE, 3),
                      generator=gen, device=DEVICE, dtype=torch.uint8)
    aug = make_device_augment(DeviceAugConfig(input_size=224))
    reset_counts()
    aug_ms = cuda_ms(lambda: aug(x, gen), runs=10, warmup=2)
    require(not any({**counts(), **launcher_counts()}.values()),
            "phase 8: the augmentation launched a kernel of the port")
    host = loader_ms(make_transform("synthetic", True, TransformConfig(
        input_size=224)), LOADER_N)
    raw = loader_ms(make_raw_transform(int(224 / 0.875 + 0.5)), LOADER_N)
    print(f"phase 8 aug b{AUG_B} of {AUG_SQUARE}-px squares on the card: "
          f"{aug_ms:.2f} ms a batch (CUDA events, median of 10; "
          f"{AUG_B / aug_ms * 1e3:.0f} img/s), no kernel of the port; the "
          f"Loader (one thread, {LOADER_N} synthetic images): host "
          f"transforms {host:.1f} ms a b{CLI_B} batch "
          f"({CLI_B / host * 1e3:.1f} img/s), uint8 squares {raw:.1f} ms "
          f"({CLI_B / raw * 1e3:.1f} img/s) on {card}; {since(t0)}",
          flush=True)


def aug_against_cpu(card: str):
    """The aug's transforms on the card against the CPU on the same uint8
    inputs at fixed parameters, and the whole aug from one seed."""
    t0 = time.perf_counter()
    from tokenreduction_tpu_torch.data import device_aug as A

    gen = torch.Generator().manual_seed(9)
    B, S = AUG_CHECK_B, AUG_SQUARE
    u8 = torch.randint(0, 256, (B, S, S, 3), generator=gen,
                       dtype=torch.uint8)
    box = (torch.randint(0, 40, (B,), generator=gen).float(),
           torch.randint(0, 40, (B,), generator=gen).float(),
           torch.randint(60, 216, (B,), generator=gen).float(),
           torch.randint(60, 216, (B,), generator=gen).float())
    flip = torch.rand(B, generator=gen) < 0.5
    mags = torch.rand(B, generator=gen) * 10
    signs = torch.where(torch.rand(B, generator=gen) < 0.5, -1.0, 1.0)

    def both(fn, *args):
        cpu = fn(*args)
        dev = fn(*[a.to(DEVICE) if torch.is_tensor(a) else a for a in args])
        return dev.cpu(), cpu

    def crop(u8_, top, left, h, w, flip_):
        return A.hflip(A.crop_resize(u8_.float(), top, left, h, w, 224),
                       flip_)

    worst = {}
    got, want = both(crop, u8, *box, flip)
    worst["crop+resize+flip"] = (got - want).abs().max().item()
    tf = A.make_device_eval_transform(A.DeviceAugConfig(input_size=224))
    got, want = both(tf, u8)
    std = min(A.IMAGENET_STD)
    worst["eval transform"] = (got - want).abs().max().item() * 255 * std
    for name, err in worst.items():
        require(err <= AUG_LEVELS, f"phase 8 aug {name}: {err:.2e} levels "
                f"> {AUG_LEVELS:.2e}")
    imgs = u8[:, :224, :224].float()
    for inc in (True, False):
        for i, op in enumerate(A.ra_op_table(inc)):
            got, want = both(lambda x, m, s: op(x, m, s, 16), imgs, mags,
                             signs)
            err = (got - want).abs()
            tag = f"RA op {i}{'' if inc else ' plain'}"
            if i in (0, 1, 2, 4, 5, 6):  # the LUT ops
                require(torch.equal(got, want), f"phase 8 aug {tag}: not "
                        f"equal ({err.max().item()} levels)")
                worst[tag] = 0.0
            elif i in (3, 11, 12, 13, 14):  # the geometric ops
                share = (err > AUG_LEVELS).float().mean().item()
                require(err.max().item() <= 1.0 and
                        share <= AUG_GEOMETRIC_SHARE,
                        f"phase 8 aug {tag}: {err.max().item()} levels, "
                        f"{share:.2e} of values beyond {AUG_LEVELS:.2e}")
                worst[tag] = err.max().item()
            else:
                require(err.max().item() <= AUG_LEVELS,
                        f"phase 8 aug {tag}: {err.max().item():.2e} levels")
                worst[tag] = err.max().item()
    aug = A.make_device_augment(A.DeviceAugConfig(input_size=224))
    x = u8.to(DEVICE)
    a = aug(x, torch.Generator(device=DEVICE).manual_seed(1))
    b = aug(x, torch.Generator(device=DEVICE).manual_seed(1))
    plain = A.make_device_augment(A.DeviceAugConfig(input_size=224,
                                                    reprob=0.0))
    c = plain(x, torch.Generator(device=DEVICE).manual_seed(1))
    mean = torch.tensor(A.IMAGENET_MEAN, device=DEVICE)[:, None, None]
    lv = (c * torch.tensor(A.IMAGENET_STD, device=DEVICE)[:, None, None]
          + mean) * 255
    require(a.shape == (B, 3, 224, 224) and a.dtype == torch.float32
            and a.device == x.device and bool(torch.isfinite(a).all())
            and torch.equal(a, b) and lv.min().item() >= -1e-3
            and lv.max().item() <= 255 + 1e-3,
            f"phase 8 aug pipeline: {a.shape} {a.dtype}, equal "
            f"{torch.equal(a, b)}, levels {lv.min().item()}.."
            f"{lv.max().item()}")
    print(f"phase 8 aug card against CPU (B={B}, {S}-px uint8 squares, "
          f"fixed parameters): worst |card - CPU| in levels of 255 "
          f"{ {k: float(f'{v:.2e}') for k, v in worst.items()} } (bounds: "
          f"crop and eval {AUG_LEVELS:.2e}, LUT ops equal, geometric at "
          f"most 1 level on {AUG_GEOMETRIC_SHARE:.0e} of values); the whole "
          f"aug "
          f"from one seed twice bitwise equal, [B, 3, 224, 224] fp32 on the "
          f"card, without erasing within 0..255 on {card}; {since(t0)}",
          flush=True)


def optimizers_against_cpu(card: str):
    """Every optimizer name, three updates of topk@0.7's params on the card
    and on the CPU from the same gradients (three fp32 B=32 batches on the
    card); AdaHessian's Hutchinson diagonal on the card (the plain
    composition, no kernel launch) against the CPU's on the same probe.
    Every param starts with seeded noise, so that no leaf starts at zero:
    a zero-initialised bias holds nothing but three updates that partly
    cancel, and fp32 itself then misses its fp64 value by 1.4e-5 of its
    max (SGD, blocks.1.mlp.fc1.bias, on the CPU)."""
    t0 = time.perf_counter()
    name, kw = MODELS["topk@0.7"]
    model, _ = create_model(name, device=DEVICE,
                            generator=torch.Generator().manual_seed(12), **kw)
    noise = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=noise).to(DEVICE))
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(13)
    grads = []
    opt, _ = create_optimizer(params0, OptimConfig(), lambda s: 1e-3, [])
    live = init_train_state(model, opt, device=DEVICE).params
    for _ in range(OPT_STEPS):
        x = images(OPT_B, gen)
        y = torch.randint(0, 1000, (OPT_B,), generator=gen).to(DEVICE)
        _, g = loss_and_grads(model, label_smoothing_loss, live, x, y,
                              StepConfig())
        grads.append(g)
    # the Hutchinson diagonal: the card's pinned model against the CPU's
    from tokenreduction_tpu_torch.train import step as train_step_mod

    hmodel = copy.deepcopy(model)
    train_step_mod.pin_plain_composition(hmodel)
    cpu_model = copy.deepcopy(hmodel).cpu()
    z = train_step_mod.rademacher_like(live, torch.Generator(
        device=DEVICE).manual_seed(14))
    x = images(DIAG_B, gen)
    y = torch.randint(0, 1000, (DIAG_B,), generator=gen).to(DEVICE)
    hmodel.train()
    cpu_model.train()
    reset_counts()
    _, _, diag = train_step_mod.hutchinson_grads_and_diag(
        hmodel, label_smoothing_loss, live, x, y, StepConfig(), z,
        torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    launched = {k: n for k, n in {**counts(), **launcher_counts()}.items()
                if n}
    require(not launched, f"phase 8 adahessian: the Hutchinson step "
            f"launched {launched}")
    cpu_live = {n: t.detach().cpu().requires_grad_(True)
                for n, t in live.items()}
    _, _, cpu_diag = train_step_mod.hutchinson_grads_and_diag(
        cpu_model, label_smoothing_loss, cpu_live, x.cpu(), y.cpu(),
        StepConfig(), {n: t.cpu() for n, t in z.items()},
        torch.Generator().manual_seed(0))
    diag_name, diag_err = max(((n, rel_err(d.cpu(), cpu_diag[n])[1])
                               for n, d in diag.items()), key=lambda t: t[1])
    require(diag_err <= DIAG_BOUND, f"phase 8 adahessian diagonal "
            f"{diag_name}: {diag_err:.2e} of max|CPU|")
    errs = {}
    for opt_name in OPT_NAMES:
        sides = {}
        for device in (DEVICE, "cpu"):
            p = {n: t.to(device).clone() for n, t in params0.items()}
            o, _ = create_optimizer(p, OptimConfig(opt=opt_name,
                                                   clip_grad=1.0,
                                                   backbone_lr_scale=0.1),
                                    lambda s: 1e-3, [], steps_per_epoch=100)
            st = o.init(p)
            for i in range(OPT_STEPS):
                extra = ({"hessian_diag": {n: d.to(device)
                                           for n, d in diag.items()}}
                         if o.needs_diag else {})
                o.update(p, {n: g.to(device) for n, g in grads[i].items()},
                         st, i, **extra)
            sides[device] = p
        worst, worst_n, beyond, total = 0.0, "", 0, 0
        for n, t in sides[DEVICE].items():
            want = sides["cpu"][n]
            err = (t.cpu() - want).abs() / max(want.abs().max().item(),
                                               1e-30)
            if err.max().item() > worst:
                worst, worst_n = err.max().item(), n
            beyond += int((err > OPT_BOUND).sum())
            total += want.numel()
        if opt_name in OPT_ILL:
            require(worst <= OPT_ILL_WORST and
                    beyond <= OPT_ILL_SHARE * total,
                    f"phase 8 --opt {opt_name}: {beyond} of {total} params "
                    f"beyond {OPT_BOUND:.0e}, {worst_n} {worst:.2e} of "
                    f"max|CPU|")
        else:
            require(worst <= OPT_BOUND, f"phase 8 --opt {opt_name}: "
                    f"{worst_n} {worst:.2e} of max|CPU| > {OPT_BOUND:.0e}")
        errs[opt_name] = (float(f"{worst:.2e}"), beyond)
    print(f"phase 8 optimizers topk@0.7 fp32 (params with seeded noise), "
          f"{OPT_STEPS} updates from the gradients of {OPT_STEPS} B={OPT_B} "
          f"batches, card against CPU: "
          f"(worst of a leaf's max|CPU|, params beyond {OPT_BOUND:.0e}) "
          f"{errs} (bound {OPT_BOUND:.0e}; {', '.join(OPT_ILL)}: at most "
          f"{OPT_ILL_SHARE:.0e} of the params beyond it, each within "
          f"{OPT_ILL_WORST:.0e}); "
          f"adahessian's Hutchinson diagonal B={DIAG_B}: no kernel launch, "
          f"worst leaf {diag_name} {diag_err:.2e} of max|CPU| (bound "
          f"{DIAG_BOUND:.0e}) on {card}; {since(t0)}", flush=True)


def brain_npz(state: dict, num_heads: int) -> dict:
    """A port ViT's state dict in the Brain-Flax .npz layout (the inverse
    of models/convert.py::convert_jax_npz)."""
    def a(t):
        return t.detach().cpu().numpy()

    out = {"embedding/kernel": a(state["patch_embed.proj.weight"]
                                 .permute(2, 3, 1, 0)),
           "embedding/bias": a(state["patch_embed.proj.bias"]),
           "cls": a(state["cls_token"]),
           "Transformer/posembed_input/pos_embedding": a(
               state["pos_embed"]),
           "Transformer/encoder_norm/scale": a(state["norm.weight"]),
           "Transformer/encoder_norm/bias": a(state["norm.bias"]),
           "head/kernel": a(state["head.weight"].t()),
           "head/bias": a(state["head.bias"])}
    i = 0
    while f"blocks.{i}.norm1.weight" in state:
        b, bp = f"blocks.{i}.", f"Transformer/encoderblock_{i}/"
        mha = bp + "MultiHeadDotProductAttention_1/"
        for ln, ours in (("LayerNorm_0", "norm1"), ("LayerNorm_2", "norm2")):
            out[f"{bp}{ln}/scale"] = a(state[b + ours + ".weight"])
            out[f"{bp}{ln}/bias"] = a(state[b + ours + ".bias"])
        w = state[b + "attn.qkv.weight"].t()
        d = w.shape[0]
        split = w.reshape(d, 3, num_heads, d // num_heads)
        bias = state[b + "attn.qkv.bias"].reshape(3, num_heads, -1)
        for j, n in enumerate(("query", "key", "value")):
            out[f"{mha}{n}/kernel"] = a(split[:, j])
            out[f"{mha}{n}/bias"] = a(bias[j])
        out[f"{mha}out/kernel"] = a(state[b + "attn.proj.weight"].t()
                                    .reshape(num_heads, -1, d))
        out[f"{mha}out/bias"] = a(state[b + "attn.proj.bias"])
        for r, fc in ((0, "fc1"), (1, "fc2")):
            out[f"{bp}MlpBlock_3/Dense_{r}/kernel"] = a(
                state[f"{b}mlp.{fc}.weight"].t())
            out[f"{bp}MlpBlock_3/Dense_{r}/bias"] = a(
                state[f"{b}mlp.{fc}.bias"])
        i += 1
    return out


def npz_finetune(root: pathlib.Path, card: str):
    """--finetune of a seeded Brain-Flax .npz at DeiT-S width
    (train/loop.py::_load_finetune) on the card and on the CPU: every
    parameter loaded as written, the fp32 logits within 1e-4 of
    max|CPU|."""
    import types

    import numpy as np

    t0 = time.perf_counter()
    name, kw = MODELS["topk@0.7"]
    src, cfg = create_model(name, device="cpu",
                            generator=torch.Generator().manual_seed(15), **kw)
    path = root / "vit.npz"
    np.savez(path, **brain_npz(src.state_dict(), HEADS))
    args = types.SimpleNamespace(finetune=str(path))
    x = images(MODEL_BATCH[torch.float32], torch.Generator().manual_seed(16))
    logits, want = {}, src.state_dict()
    for device in (DEVICE, "cpu"):
        model, _ = create_model(name, device=device,
                                generator=torch.Generator().manual_seed(0),
                                **kw)
        report = train_loop._load_finetune(args, model, cfg)
        require(not report["shape_mismatch"] and not
                report["missing_in_ckpt"] and all(
                    torch.equal(t.cpu(), want[n])
                    for n, t in model.state_dict().items()),
                f"phase 8 --finetune .npz on {device}: {report}")
        with torch.no_grad():
            logits[device] = model.eval()(x.to(device))
    _, err = rel_err(logits[DEVICE].cpu(), logits["cpu"])
    require(err <= NPZ_BOUND, f"phase 8 --finetune .npz: logits {err:.2e} "
            f"of max|CPU|")
    print(f"phase 8 --finetune of a seeded Brain-Flax .npz, topk@0.7 at "
          f"DeiT-S width ({len(report['loaded'])} params, each as written): "
          f"fp32 logits B={MODEL_BATCH[torch.float32]} card against CPU "
          f"{err:.2e} of max|CPU| (bound {NPZ_BOUND:.0e}) on {card}; "
          f"{since(t0)}", flush=True)


def phase_flags(card: str) -> dict:
    """Phase 8 (see the module docstring). Returns the launch counts of its
    train CLI runs, summed, for the kernels' record."""
    root = pathlib.Path(__file__).resolve().parent / "build" / "phase8"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    total = dict.fromkeys([*WRAPPERS, *LAUNCHERS], 0)
    settle()
    aug_cli("amp", True, root, total, card)
    aug_cli("fp32", False, root, total, card)
    aug_times(card)
    aug_against_cpu(card)
    optimizers_against_cpu(card)
    npz_finetune(root, card)
    shutil.rmtree(root, ignore_errors=True)
    return total


# ---- phase 9: the kernel tools (tokenreduction_tpu_torch/tools/)
# the tools' four kernels: (the wrapper's count, or the backward's, the
# CUDA sources, the wrapper, the TPU kernel it replaces)
TOOLS_SRC = "tokenreduction_tpu_torch/tools"
TOOL_KERNELS = {
    "attn_joint": (
        (tune_kernels.attn_joint, "launches"),
        ["tokenreduction_tpu_torch/csrc/attn_joint.cu", LN_GEMM, GEMM_SOURCE],
        f"{TOOLS_SRC}/tune_kernels.py", "tools/tune_kernels.py:160"),
    "mlp_chunked": (
        (tune_kernels.mlp_chunked, "launches"),
        ["tokenreduction_tpu_torch/csrc/mlp_chunked.cu"],
        f"{TOOLS_SRC}/tune_kernels.py", "tools/tune_kernels.py:282"),
    "attend_block_res": (
        (proto_residual_fuse.attend_block_res, "launches"),
        [GEMM_SOURCE, ATTENTION_SM90, LN_GEMM],
        f"{TOOLS_SRC}/proto_residual_fuse.py",
        "tools/proto_residual_fuse.py:228"),
    "attend_block_res_bwd": (
        (proto_residual_fuse.attend_block_res, "backward_launches"),
        [LN_GEMM, GEMM_SOURCE, ATTENTION_SM90],
        f"{TOOLS_SRC}/proto_residual_fuse.py",
        "tools/proto_residual_fuse.py:263"),
}
# the launchers the tools' kernels add (ops/_build.py), each against the
# wrapper whose every call launches it once
TOOL_LAUNCHERS = {
    "attn_joint": (_build.attn_joint, "launches"),
    "mlp_chunked": (_build.mlp_chunked, "launches"),
    "attend_block_res": (_build.gemm, "scaled_launches"),
    "attend_block_res_bwd": (_build.layer_norm_bwd, "res_launches"),
}
TOOLS_N = (197, 138, 97, 68)  # topk@0.7's widths
TOOLS_RES_N = (197, 138, 97)  # proto_residual_fuse's
# the tools' entry points, each with few calls a timed run: the path that
# the four kernels' launch counts are read from
TOOL_RUNS = ((tune_kernels, ["--iters", "3"]),
             (proto_residual_fuse, ["--iters", "2"]),
             (profile_kernels, ["--iters", "3"]),
             (profile_train_kernels, ["--iters", "2"]),
             (profile_keep025, ["--iters", "2"]))


def tool_counts() -> dict:
    return {name: (getattr(f, attr), getattr(*TOOL_LAUNCHERS[name]))
            for name, ((f, attr), *_) in TOOL_KERNELS.items()}


def reset_tool_counts():
    for (f, attr), *_ in TOOL_KERNELS.values():
        setattr(f, attr, 0)
    for f, attr in TOOL_LAUNCHERS.values():
        setattr(f, attr, 0)
    _build.row_scale.launches = 0


def tool_weights(gen) -> dict:
    """block_params under the tools' names (the attention half's and the
    MLP half's LayerNorm as ls, lb in turn)."""
    p = block_params(torch.bfloat16, gen)
    return dict(ls=p["ls1"], lb=p["lb1"], ls2=p["ls2"], lb2=p["lb2"],
                **{k: p[k] for k in ("wqkv", "bqkv", "wproj", "bproj", "w1",
                                     "b1", "w2", "b2")})


def res_bound(kind: str, B: int, N: int) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of the residual-fused branch,
    bf16, from its code: forward, the qkv and proj products and the two
    attention products; x, s, the weights in, out and row0 out. Backward,
    the products' two gradients each (no recompute); x, dy, drow0, s and
    the weights in, dx and the weights' gradients out."""
    M, E = B * N, 2
    attn_w = 4 * D * D + 6 * D
    row0, s = 4 * B * HEADS * N, 4 * B
    if kind == "fwd":
        flops = 8 * M * D * D + 4 * B * N * N * D
        nbytes = E * (2 * M * D + attn_w) + row0 + s
    else:
        flops = 16 * M * D * D + 8 * B * N * N * D
        nbytes = E * (3 * M * D + 2 * attn_w) + row0 + s
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


def same_bits(first, second) -> bool:
    return all(torch.equal(a, b) for a, b in zip(first, second))


def tool_check(name, shape, got, want, labels, rec, phase="9"):
    """Each output against its plain version: within the bf16 BOUND of its
    own max|plain|; the record's max_abs_err is out's or dx's."""
    errs = []
    for label, g, w in zip(labels, got, want):
        abs_err, rel = rel_err(g, w)
        tol = BOUND[torch.bfloat16]
        require(rel <= tol, f"phase {phase} {name} {shape} {label}: error "
                f"{rel:.3e} of max|plain| > bound {tol:.0e}")
        errs.append(f"{label} {abs_err:.3e} ({rel:.2e} rel)")
        if label in ("out", "dx"):
            rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    return errs


def branch_check(name, shape, kernel, plain, x, rec, phase="9"):
    """The branch alone, out - x, within 2e-2 of its own max|plain|, from
    x scaled by 2^-4 (LayerNorm makes the branch nearly the same): at the
    residual's full size out's rounding, an ulp of |x|, hides it."""
    xs = x * 0.0625
    return tool_check(name, shape, [kernel(xs).float() - xs.float()],
                      [plain(xs).float() - xs.float()], ("branch",), rec,
                      phase=phase)


def tool_record(rec, shape, ms, plain_ms, bound_, route_ms):
    if "shape" not in rec:  # the widest shape stands for the kernel
        rec.update(shape=f"bf16 {shape}", ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_[0], bound_by=bound_[1],
                   current_route_ms=route_ms)


def tool_line(name, shape, errs, ms, plain_ms, bound_, route, route_ms):
    """ms and route_ms: one of ten back-to-back calls between two CUDA
    events (per_launch_ms), so that the host's launch costs stay hidden
    where the card takes longer than the host."""
    print(f"phase 9 {name} {shape}: max abs err {', '.join(errs)}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_[0]:.4f} ms "
          f"({bound_[1]}), the port's current route ({route}) "
          f"{route_ms:.4f} ms; a second launch bit-equal", flush=True)


# untimed widths at the edges of the kernels' tiles: (B, N) of the joint
# attention (four full key tiles; an image shorter than a 64-row box) and
# of the chunked MLP (rows no multiple of a block's 128)
JOINT_EDGES = ((4, 256), (5, 13))
CHUNKED_EDGES = ((3, 197), (1, 5))


def joint_check(gen, w, rec, B, N):
    """attn_joint against attn_joint_ref at (B, N): the block's output,
    the by-products, the branch (branch_check) and the merged heads of the
    kernel's launch alone (from LN1's rows), each within 2e-2 of its own
    max|plain| (q, k and v are rounded inside the kernel from its own
    fp32 sums, which may round a bf16 ulp apart from the plain
    version's); a second launch bit-equal. Returns (x, LN1's
    rows, the max-error labels, the kernel's call, the plain call)."""
    x = torch.randn(B, N, D, generator=gen).to(DEVICE, torch.bfloat16)

    def kernel(x=x):
        out, (row0, colsum) = tune_kernels.attn_joint(
            x, w, HEADS, SCALE, with_scores=True)
        return [out, row0, colsum]

    def plain(x=x):
        return list(tune_kernels.attn_joint_ref(x, w, HEADS, SCALE))

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    shape = f"B={B} N={N}"
    errs = tool_check("attn_joint", shape, got, want,
                      ("out", "row0", "colsum"), rec)
    errs += branch_check(
        "attn_joint", shape,
        lambda xs: tune_kernels.attn_joint(xs, w, HEADS, SCALE),
        lambda xs: tune_kernels.attn_joint_ref(xs, w, HEADS, SCALE)[0],
        x, rec)
    require(same_bits(got, kernel()), f"attn_joint {shape}: two "
            "launches differ")
    # the kernel's launch alone: the merged heads from LN1's rows
    ln = layer_norm_f32(x.float(), w["ls"], w["lb"], EPS).to(torch.bfloat16)
    merged = torch.empty_like(x)
    _build.attn_joint(ln, w["wqkv"], w["bqkv"], merged, HEADS, SCALE)
    qkv = linear_f32(ln, w["wqkv"], w["bqkv"]).to(torch.bfloat16)
    errs += tool_check(
        "attn_joint", shape, [merged],
        [tune_kernels.joint_attention_ref(qkv, HEADS, SCALE)[0]],
        ("merged heads alone",), rec)
    return x, ln, errs, kernel, plain


def joint_cases(gen, w, rec):
    """joint_check at JOINT_EDGES (untimed) and at TOOLS_N, B=256; at
    TOOLS_N each time by CUDA events beside the bound, the plain version,
    the port's current route and SDPA's attention alone on the same q, k
    and v (the library time of the attention core)."""
    for B, N in JOINT_EDGES:
        errs = joint_check(gen, w, rec, B, N)[2]
        print(f"phase 9 attn_joint B={B} N={N} (untimed): max abs err "
              f"{', '.join(errs)}; a second launch bit-equal", flush=True)
    B = TRAIN_B
    for N in TOOLS_N:
        x, ln, errs, kernel, plain = joint_check(gen, w, rec, B, N)
        shape = f"B={B} N={N}"
        ms, plain_ms = per_launch_ms(kernel), cuda_ms(plain)
        route_ms = per_launch_ms(
            lambda x=x: tune_kernels.current_attention(x, w))
        q, k, v = packed_heads(
            linear_f32(ln, w["wqkv"], w["bqkv"]).to(torch.bfloat16), HEADS)
        sdpa_ms = per_launch_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=SCALE))
        b = bound("fused_block_attention", B, N)
        tool_line("attn_joint", shape, errs, ms, plain_ms, b,
                  "fused_block_attention", route_ms)
        print(f"phase 9 attn_joint {shape}: SDPA on the same q, k, v (the "
              f"attention output alone) {sdpa_ms:.4f} ms", flush=True)
        if "shape" not in rec:
            rec["sdpa_ms"] = sdpa_ms
        tool_record(rec, shape, ms, plain_ms, b, route_ms)


def chunked_check(gen, wm, rec, B, N):
    """mlp_chunked against mlp_chunked_ref at (B, N): the output within
    2e-2 of max|plain| and its branch (branch_check) within 2e-2 of its
    own max; a second launch and chunks = 2 the same bits as chunks = 4.
    Returns (x, the max-error labels)."""
    x = torch.randn(B, N, D, generator=gen).to(DEVICE, torch.bfloat16)
    got = tune_kernels.mlp_chunked(x, wm, 4)
    want = tune_kernels.mlp_chunked_ref(x, wm)
    torch.cuda.synchronize()
    shape = f"B={B} N={N}"
    errs = tool_check("mlp_chunked", shape, [got], [want], ("out",), rec)
    errs += branch_check(
        "mlp_chunked", shape,
        lambda xs: tune_kernels.mlp_chunked(xs, wm, 4),
        lambda xs: tune_kernels.mlp_chunked_ref(xs, wm), x, rec)
    require(torch.equal(got, tune_kernels.mlp_chunked(x, wm, 4)),
            f"mlp_chunked {shape}: two launches differ")
    require(torch.equal(got, tune_kernels.mlp_chunked(x, wm, 2)),
            f"mlp_chunked {shape}: chunks=2 differs from chunks=4")
    return x, errs


def chunked_cases(gen, w, rec):
    """chunked_check at CHUNKED_EDGES (untimed) and at TOOLS_N, B=256,
    there timed beside the bound, the plain version and the route."""
    wm = dict(w, ls=w["ls2"], lb=w["lb2"])
    for B, N in CHUNKED_EDGES:
        errs = chunked_check(gen, wm, rec, B, N)[1]
        print(f"phase 9 mlp_chunked B={B} N={N} (untimed, {B * N} rows): "
              f"max abs err {', '.join(errs)}; a second launch and "
              "chunks=2 bit-equal", flush=True)
    B = TRAIN_B
    for N in TOOLS_N:
        x, errs = chunked_check(gen, wm, rec, B, N)
        shape = f"B={B} N={N}"
        ms = per_launch_ms(lambda x=x: tune_kernels.mlp_chunked(x, wm, 4))
        plain_ms = cuda_ms(lambda x=x: tune_kernels.mlp_chunked_ref(x, wm))
        route_ms = per_launch_ms(lambda x=x: tune_kernels.current_mlp(x, wm))
        b = bound("fused_mlp_residual", B, N)
        tool_line("mlp_chunked", shape, errs, ms, plain_ms, b,
                  "fused_mlp_residual", route_ms)
        tool_record(rec, shape, ms, plain_ms, b, route_ms)


def outside_res(x, s, *ps):
    """The port's composition of the same half (core/layers.py
    Block.attend with DropPath): the branch's kernels, then x +
    where(kept, branch / keep, 0) in PyTorch."""
    br, row0 = attend_branch_train(x, *ps, HEADS, SCALE, EPS)
    kept = (s > 0)[:, None, None]
    return x + torch.where(kept, br / proto_residual_fuse.KEEP,
                           torch.zeros_like(br)), row0


def res_cases(gen, w, recs):
    """attend_block_res (forward) and its backward against their plain
    versions, with a drop-path scale that drops images (0) and keeps
    others (1 / 0.9): out, row0 and the seven gradients for random
    cotangents (dy, drow0), each within 2e-2 of its own max|plain|."""
    B = TRAIN_B
    ps = [w[k] for k in proto_residual_fuse.PARAMS]
    s = proto_residual_fuse.drop_scale(B, DEVICE)
    require(bool((s == 0).any()) and bool((s > 0).any()),
            "the drop-path scale drops no image or keeps none")
    for N in TOOLS_RES_N:
        x = torch.randn(B, N, D, generator=gen).to(DEVICE, torch.bfloat16)
        dy = torch.randn(B, N, D, generator=gen).to(DEVICE, torch.bfloat16)
        drow0 = torch.randn(B, HEADS, N, generator=gen).to(DEVICE)
        leaves = [t.detach().requires_grad_() for t in (x, *ps)]

        def run(fn):
            outs = fn(leaves[0], s, *leaves[1:])
            return outs, list(torch.autograd.grad(outs, leaves, (dy, drow0)))

        def fused(x_, s_, *p_):
            return proto_residual_fuse.attend_block_res(
                x_, *p_, s_, HEADS, SCALE, EPS)

        (out, row0), grads = run(fused)
        want_fwd = proto_residual_fuse.attend_block_res_ref(
            x, *ps, s, HEADS, SCALE, EPS)
        want_bwd = proto_residual_fuse.attend_block_res_bwd_ref(
            x, *ps[:5], s, dy, drow0, HEADS, SCALE, EPS)
        torch.cuda.synchronize()
        shape = f"B={B} N={N}"
        errs_f = tool_check("attend_block_res", shape, [out, row0],
                            list(want_fwd), ("out", "row0"),
                            recs["attend_block_res"])
        with torch.no_grad():
            errs_f += branch_check(
                "attend_block_res", shape, lambda xs: fused(xs, s, *ps)[0],
                lambda xs: proto_residual_fuse.attend_block_res_ref(
                    xs, *ps, s, HEADS, SCALE, EPS)[0],
                x, recs["attend_block_res"])
        labels = ("dx", "d ln1 scale", "d ln1 bias", "d wqkv", "d bqkv",
                  "d wproj", "d bproj")
        errs_b = tool_check("attend_block_res_bwd", shape, grads,
                            list(want_bwd), labels,
                            recs["attend_block_res_bwd"])
        again = run(fused)
        require(same_bits([out, row0, *grads], [*again[0], *again[1]]),
                f"attend_block_res {shape}: two launches differ")
        # times: the forward alone and the backward alone, each beside its
        # plain version and the port's composition; the backward as its
        # chain of launches (fused_block_train._bwd_cuda, the same for
        # both but for the options), without autograd's own host work
        saved = fused_block_train._fwd_cuda(x, *ps, HEADS, SCALE, EPS)[2]
        kept = (s > 0)[:, None, None]

        def bwd():
            return fused_block_train._bwd_cuda(x, ps[0], ps[2], ps[4], saved,
                                               dy, drow0, HEADS, SCALE, EPS,
                                               s=s)

        def bwd_route():  # autograd's passes of x + where(kept, br / keep, 0)
            dyb = torch.where(kept, dy / proto_residual_fuse.KEEP,
                              torch.zeros_like(dy))
            dx, *rest = fused_block_train._bwd_cuda(
                x, ps[0], ps[2], ps[4], saved, dyb, drow0, HEADS, SCALE, EPS)
            return dx + dy, *rest

        with torch.no_grad():
            ms_f = per_launch_ms(lambda: fused(x, s, *ps))
            route_f = per_launch_ms(lambda: outside_res(x, s, *ps))
        ms_b, route_b = per_launch_ms(bwd), per_launch_ms(bwd_route)
        plain_f = cuda_ms(lambda: proto_residual_fuse.attend_block_res_ref(
            x, *ps, s, HEADS, SCALE, EPS))
        plain_b = cuda_ms(
            lambda: proto_residual_fuse.attend_block_res_bwd_ref(
                x, *ps[:5], s, dy, drow0, HEADS, SCALE, EPS))
        for name, errs, ms, plain_ms, kind, route_ms in (
                ("attend_block_res", errs_f, ms_f, plain_f, "fwd", route_f),
                ("attend_block_res_bwd", errs_b, ms_b, plain_b, "bwd",
                 route_b)):
            b = res_bound(kind, B, N)
            tool_line(name, shape, errs, ms, plain_ms, b,
                      "attend_branch_train + x + drop_path(branch)", route_ms)
            tool_record(recs[name], shape, ms, plain_ms, b, route_ms)


def phase_tools() -> dict:
    """Phase 9 (see the module docstring). Returns the four kernels'
    records for the JSON line, their launches those of the tools' runs."""
    gen = torch.Generator().manual_seed(9)
    w = tool_weights(gen)
    recs = {name: dict(max_abs_err=0.0) for name in TOOL_KERNELS}
    settle()
    joint_cases(gen, w, recs["attn_joint"])
    chunked_cases(gen, w, recs["mlp_chunked"])
    res_cases(gen, w, recs)
    settle()
    reset_tool_counts()
    for module, argv in TOOL_RUNS:
        t0 = time.perf_counter()
        module.main(argv)
        print(f"phase 9 ran {module.__name__.split('.')[-1]} "
              f"{' '.join(argv)} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    torch.cuda.synchronize()
    for name, (wrapper, launcher) in tool_counts().items():
        require(wrapper > 0, f"{name}: no launch in the tools' runs")
        require(launcher == wrapper, f"{name}: {launcher} kernel launches "
                f"for {wrapper} calls")
        recs[name]["launches"] = wrapper
    require(_build.row_scale.launches == tool_counts()[
        "attend_block_res_bwd"][0], "row_scale: not once a fused backward")
    print(f"phase 9 launches in the tools' runs: "
          f"{ {n: c[0] for n, c in tool_counts().items()} } (row_scale "
          f"{_build.row_scale.launches})", flush=True)
    return recs


# ---- phase 10: the last kernel tools (tokenreduction_tpu_torch/tools/)
# the two attention-core prototypes' kernels: (the wrapper's count, the
# CUDA sources, the wrapper, the TPU kernel it replaces)
ATTN_HEADER = "tokenreduction_tpu_torch/csrc/attention_sm90.cuh"
PROTO_KERNELS = {
    "proto_attn": (
        (proto_attn.proto_attn, "launches"),
        ["tokenreduction_tpu_torch/csrc/proto_attn.cu", ATTN_HEADER,
         GEMM_SOURCE],
        f"{TOOLS_SRC}/proto_attn.py", "tools/proto_attn.py:137"),
    "proto_attn_bwd": (
        (proto_attn_bwd.proto_attn_bwd, "launches"),
        ["tokenreduction_tpu_torch/csrc/proto_attn_bwd.cu", ATTN_HEADER,
         LN_GEMM, GEMM_SOURCE],
        f"{TOOLS_SRC}/proto_attn_bwd.py", "tools/proto_attn_bwd.py:190"),
}
# each wrapper's kernel launcher (ops/_build.py), once a call
PROTO_LAUNCHERS = {"proto_attn": (_build.proto_attn, "launches"),
                   "proto_attn_bwd": (_build.proto_attn_bwd, "launches")}
PROTO_N = (197, 138, 97, 68)  # proto_attn.py's widths
PROTO_BWD_N = (197, 138, 97, 50)  # proto_attn_bwd.py's
# #14's branch check: x scaled by 2^-4 and the weights by powers of two
# (exact in bf16) so that the branch, not x, sets out's rounding: with no
# LayerNorm the branch shrinks with x, so scaling x alone hides it still
BRANCH_SCALE = dict(x=2.0 ** -4, wqkv=2.0 ** 4, wproj=2.0 ** 6)


def proto_counts() -> dict:
    return {name: (getattr(f, attr), getattr(*PROTO_LAUNCHERS[name]))
            for name, ((f, attr), *_) in PROTO_KERNELS.items()}


def reset_proto_counts():
    for (f, attr), *_ in PROTO_KERNELS.values():
        setattr(f, attr, 0)
    for f, attr in PROTO_LAUNCHERS.values():
        setattr(f, attr, 0)


def counted(name: str, calls: int, fn):
    """fn() with the kernel's counts set to 0 just before and read just
    after: its wrapper and its launcher each ``calls`` times."""
    reset_proto_counts()
    out = fn()
    torch.cuda.synchronize()
    got = proto_counts()[name]
    require(got == (calls, calls), f"phase 10 {name}: counts {got} for "
            f"{calls} calls")
    return out


# untimed (B, N) at the edges of the new tiling: four full key tiles (the
# stacked buffer at its largest), an image shorter than a 16-row box;
# #15's last query and key tiles partial (65)
PROTO_EDGES = ((4, 256), (5, 13))
PROTO_BWD_EDGES = ((4, 256), (5, 13), (4, 65))


def proto_attn_check(w, wb, rec, B, N):
    """#14's arrangements at (B, N) against proto_attn_ref (out, the branch
    out - x at BRANCH_SCALE, the merged heads of the kernel's launch
    alone), each call counted, a second launch bit-equal. Returns ({variant:
    out}, {variant: the max-error labels}, x)."""
    x = _measure.inputs(B, N, DEVICE, seed=N)
    xs = x * BRANCH_SCALE["x"]
    shape = f"B={B} N={N}"
    want = proto_attn.proto_attn_ref(x, w)
    want_b = proto_attn.proto_attn_ref(xs, wb).float() - xs.float()
    qkv = (x.float() @ w["wqkv"].float().T).to(torch.bfloat16)
    want_m = tune_kernels.joint_attention_ref(qkv, HEADS, SCALE)[0]
    outs, errs = {}, {}
    for variant in proto_attn.VARIANTS:
        got = counted("proto_attn", 2, lambda: [
            proto_attn.proto_attn(x, w, variant),
            proto_attn.proto_attn(xs, wb, variant).float() - xs.float()])
        merged = torch.empty_like(x)
        _build.proto_attn(qkv, merged, HEADS, SCALE, variant=variant)
        errs[variant] = tool_check(
            "proto_attn", f"{shape} {variant}", [*got, merged],
            [want, want_b, want_m], ("out", "branch", "merged heads alone"),
            rec, phase="10")
        require(torch.equal(got[0], proto_attn.proto_attn(x, w, variant)),
                f"proto_attn {shape} {variant}: two launches differ")
        outs[variant] = got[0]
    return outs, errs, x


def proto_attn_cases(rec):
    """#14: every arrangement at PROTO_EDGES (untimed) and at PROTO_N,
    B=256, against proto_attn_ref (proto_attn_check), the arrangements
    against each other, and at PROTO_N the times."""
    w = {k: v for k, v in proto_weights().items()
         if k in ("wqkv", "wproj")}
    wb = {k: v * BRANCH_SCALE[k] for k, v in w.items()}
    for B, N in PROTO_EDGES:
        errs = proto_attn_check(w, wb, rec, B, N)[1]
        for variant in proto_attn.VARIANTS:
            print(f"phase 10 proto_attn B={B} N={N} {variant} (untimed): max "
                  f"abs err {', '.join(errs[variant])}; a second launch "
                  "bit-equal", flush=True)
    B = TRAIN_B
    rec["arrangement_ms"] = {}
    for N in PROTO_N:
        shape = f"B={B} N={N}"
        outs, errs, x = proto_attn_check(w, wb, rec, B, N)
        times = {}
        for variant in proto_attn.VARIANTS:
            times[variant] = per_launch_ms(
                lambda: proto_attn.proto_attn(x, w, variant))
            print(f"phase 10 proto_attn {shape} {variant}: max abs err "
                  f"{', '.join(errs[variant])}; {times[variant]:.4f} ms; "
                  f"{_build.proto_attn_smem(N, HEADS, variant)} bytes of "
                  "dynamic shared memory a block; a second launch bit-equal",
                  flush=True)
        for variant in proto_attn.VARIANTS[1:]:
            same = torch.equal(outs[variant], outs["loop"])
            d = tune_kernels.max_diff(outs[variant], outs["loop"])
            print(f"phase 10 proto_attn {shape}: {variant} against loop "
                  f"max|d| {d:.3e}"
                  f"{' (the same bits)' if same else ''}", flush=True)
        plain_ms = cuda_ms(lambda: proto_attn.proto_attn_ref(x, w))
        route_ms = per_launch_ms(lambda: proto_attn.current_route(x, w))
        b = _measure.bound_ms(*proto_attn.cost(B, N))
        print(f"phase 10 proto_attn {shape}: kernel (loop) "
              f"{times['loop']:.4f} ms, avpair {times['avpair']:.4f}, "
              f"stacked {times['stacked']:.4f}; plain {plain_ms:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]}), the port's current route (qkv "
              f"gemm, short_attention, proj gemm) {route_ms:.4f} ms",
              flush=True)
        rec["arrangement_ms"][N] = times
        tool_record(rec, shape, times["loop"], plain_ms, b, route_ms)


def proto_weights() -> dict:
    """The branch's weights under the tools' names, LN and biases away from
    1 and 0 (seeded)."""
    gen = torch.Generator().manual_seed(10)
    w = tool_weights(gen)
    return {k: w[k] for k in ("ls", "lb", "wqkv", "bqkv", "wproj")}


def proto_bwd_check(w, rec, B, N):
    """#15's arrangements at (B, N) with seeded cotangents and drow0
    against proto_attn_bwd_ref (dx, dwqkv, dwproj) and the kernel's launch
    alone (merged and dqkv against the plain attention's), each call
    counted, a second launch bit-equal. Returns ({variant: outputs},
    {variant: the max-error labels}, x, dy, drow0)."""
    x = _measure.inputs(B, N, DEVICE, seed=N)
    dy, drow0 = proto_attn_bwd.cotangents(B, N, DEVICE, seed=N + 1)
    shape = f"B={B} N={N}"
    want = proto_attn_bwd.proto_attn_bwd_ref(x, w, dy, drow0)
    ln = layer_norm_f32(x.float(), w["ls"], w["lb"], EPS).to(torch.bfloat16)
    qkv = linear_f32(ln, w["wqkv"], w["bqkv"]).to(torch.bfloat16)
    dout = (dy.float() @ w["wproj"].float()).to(torch.bfloat16)
    want_k = [attention_train_ref(qkv, HEADS, SCALE)[0],
              attention_bwd_ref(qkv, dout, drow0, HEADS, SCALE)]
    outs, errs = {}, {}
    for variant in proto_attn_bwd.VARIANTS:
        got = counted("proto_attn_bwd", 1, lambda:
                      proto_attn_bwd.proto_attn_bwd(x, w, dy, drow0, variant))
        merged, dqkv = torch.empty_like(x), torch.empty_like(qkv)
        _build.proto_attn_bwd(qkv, dout, drow0, merged, dqkv, HEADS, SCALE,
                              variant=variant)
        errs[variant] = tool_check(
            "proto_attn_bwd", f"{shape} {variant}", [*got, merged, dqkv],
            [*want, *want_k], ("dx", "dwqkv", "dwproj", "merged alone",
                               "dqkv alone"), rec, phase="10")
        again = proto_attn_bwd.proto_attn_bwd(x, w, dy, drow0, variant)
        require(same_bits(got, again), f"proto_attn_bwd {shape} {variant}: "
                "two launches differ")
        outs[variant] = got
    return outs, errs, x, dy, drow0


def proto_bwd_cases(rec):
    """#15: both arrangements at PROTO_BWD_EDGES (untimed) and at
    PROTO_BWD_N, B=256 (proto_bwd_check), the arrangements against each
    other, and at PROTO_BWD_N the times."""
    w = proto_weights()
    for B, N in PROTO_BWD_EDGES:
        errs = proto_bwd_check(w, rec, B, N)[1]
        for variant in proto_attn_bwd.VARIANTS:
            print(f"phase 10 proto_attn_bwd B={B} N={N} {variant} (untimed): "
                  f"max abs err {', '.join(errs[variant])}; a second launch "
                  "bit-equal", flush=True)
    B = TRAIN_B
    rec["arrangement_ms"] = {}
    for N in PROTO_BWD_N:
        shape = f"B={B} N={N}"
        outs, errs, x, dy, drow0 = proto_bwd_check(w, rec, B, N)
        times = {}
        for variant in proto_attn_bwd.VARIANTS:
            times[variant] = per_launch_ms(
                lambda: proto_attn_bwd.proto_attn_bwd(x, w, dy, drow0,
                                                      variant))
            print(f"phase 10 proto_attn_bwd {shape} {variant}: max abs err "
                  f"{', '.join(errs[variant])}; {times[variant]:.4f} ms; "
                  f"{_build.proto_attn_bwd_smem(N)} bytes of dynamic shared "
                  "memory a block; a second launch bit-equal", flush=True)
        diffs = [f"{name} {tune_kernels.max_diff(a, b):.3e}"
                 for name, a, b in zip(proto_attn_bwd.OUTPUTS, outs["pack2"],
                                       outs["loop"])]
        print(f"phase 10 proto_attn_bwd {shape}: pack2 against loop max|d| "
              f"{', '.join(diffs)}", flush=True)
        plain_ms = cuda_ms(lambda: proto_attn_bwd.proto_attn_bwd_ref(
            x, w, dy, drow0))
        route_ms = per_launch_ms(lambda: proto_attn_bwd.current_route(
            x, w, dy, drow0))
        b = _measure.bound_ms(*proto_attn_bwd.cost(B, N))
        print(f"phase 10 proto_attn_bwd {shape}: kernel (loop) "
              f"{times['loop']:.4f} ms, pack2 {times['pack2']:.4f}; plain "
              f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), the port's "
              f"current route (#9's forward + backward) {route_ms:.4f} ms",
              flush=True)
        rec["arrangement_ms"][N] = times
        tool_record(rec, shape, times["loop"], plain_ms, b, route_ms)


def proto_gelu_cases():
    """proto_gelu's variants of #4's route at B=256, N=197 against
    mlp_variant_ref: out and the branch (branch_check; not for no-LN,
    whose branch shrinks with x) within 2e-2 of their own max|plain|, two
    bf16 GEMM launches a call, a second call bit-equal. Then the fc1
    launch alone in the variant's activation, fp32 out from the same LN
    rows (the tanh GELU the GEMM's own variant): within 1e-4 of its own
    max|plain| and nearer its own form than a tenth of its distance to
    the other GELU form (erf and tanh differ by at most 4.7e-4, under
    bf16's rounding and under 1e-4 of the max, so a launch in the wrong
    form would pass the other bounds)."""
    B, N = TRAIN_B, 197
    w = tool_weights(torch.Generator().manual_seed(12))
    x = _measure.inputs(B, N, DEVICE, seed=N + 2)
    ln = layer_norm_f32(x.float(), w["ls"], w["lb"], EPS).to(torch.bfloat16)
    rec = dict(max_abs_err=0.0)
    for variant in proto_gelu.VARIANTS:
        shape = f"B={B} N={N} {variant}"
        _build.gemm.launches = 0
        got = proto_gelu.mlp_variant(x, w, variant)
        torch.cuda.synchronize()
        require(_build.gemm.launches == 2, f"phase 10 proto_gelu {shape}: "
                f"{_build.gemm.launches} bf16 GEMM launches for 2")
        errs = tool_check("proto_gelu", shape, [got],
                          [proto_gelu.mlp_variant_ref(x, w, variant)],
                          ("out",), rec, phase="10")
        if variant != "no-LN":
            errs += branch_check(
                "proto_gelu", shape,
                lambda xs: proto_gelu.mlp_variant(xs, w, variant),
                lambda xs: proto_gelu.mlp_variant_ref(xs, w, variant), x, rec,
                phase="10")
        require(torch.equal(got, proto_gelu.mlp_variant(x, w, variant)),
                f"proto_gelu {shape}: two calls differ")
        rows = (x if variant == "no-LN" else ln).view(B * N, D)
        act = proto_gelu.GEMM_GELU[variant]
        hidden = torch.empty(B * N, w["w1"].shape[0], device=DEVICE)
        _build.gemm(rows, w["w1"], w["b1"], hidden, gelu=_build.Gelu[act])
        pre = linear_f32(rows, w["w1"], w["b1"])
        want = proto_gelu.ACTIVATION[variant](pre)
        other = proto_gelu.ACTIVATION["tanh" if act == "ERF" else "erf"](pre)
        del pre
        own = float((hidden - want).abs().max())
        cross = float((hidden - other).abs().max())
        top = float(want.abs().max())
        require(own <= LAUNCH_BOUND[torch.float32] * top and 10 * own <= cross,
                f"phase 10 proto_gelu {shape}: the fc1 launch alone is "
                f"{own:.3e} from its own form (max {top:.3e}) and {cross:.3e} "
                "from the other")
        ms = per_launch_ms(lambda: proto_gelu.mlp_variant(x, w, variant))
        print(f"phase 10 proto_gelu {shape}: max abs err {', '.join(errs)}; "
              f"the fc1 launch alone, fp32 out: {own:.3e} from its own form, "
              f"{cross:.3e} from the other (max {top:.3e}); {ms:.4f} ms; a "
              "second call bit-equal", flush=True)


def seeded_pth(root: pathlib.Path) -> pathlib.Path:
    """A seeded DeiT-S state dict in the released .pth's layout (timm's
    names, under "model"), for accuracy_gate's parity step."""
    model, _ = create_model("deit_small_patch16_224_local", device="cpu",
                            generator=torch.Generator().manual_seed(11))
    path = root / accuracy_gate.WEIGHT_FILE
    torch.save({"model": model.state_dict()}, path)
    return path


def phase_proto() -> dict:
    """Phase 10 (see the module docstring). Returns #14's and #15's
    records for the JSON line, their launches those of the tools' runs."""
    t0 = time.perf_counter()
    recs = {name: dict(max_abs_err=0.0) for name in PROTO_KERNELS}
    settle()
    proto_attn_cases(recs["proto_attn"])
    proto_bwd_cases(recs["proto_attn_bwd"])
    proto_gelu_cases()
    settle()
    runs_dir = pathlib.Path(__file__).resolve().parent / "build" / "phase10"
    shutil.rmtree(runs_dir, ignore_errors=True)
    runs_dir.mkdir(parents=True)
    runs = ((proto_attn, ["--iters", "2"]),
            (proto_attn_bwd, ["--iters", "2"]),
            (proto_gelu, ["--iters", "2"]),
            (proto_opt, ["--iters", "2"]),
            (profile_eval, ["--iters", "1"]),
            (profile_train, ["--iters", "1"]),
            (bench_input, ["--host", "--n", "128", "--device", "--iters",
                           "2"]),
            (accuracy_gate, ["--weights", str(seeded_pth(runs_dir))]),
            (tpu_parity, ["--mt-steps", "32", "--mt-batch", "32", "--ref",
                          str(runs_dir / "parity_ref.pt")]))
    reset_proto_counts()
    for module, argv in runs:
        t1 = time.perf_counter()
        rc = module.main(argv)
        require(not rc, f"phase 10 {module.__name__}: exit {rc}")
        print(f"phase 10 ran {module.__name__.split('.')[-1]} "
              f"{' '.join(argv)} in {time.perf_counter() - t1:.1f} s",
              flush=True)
    torch.cuda.synchronize()
    for name, (wrapper, launcher) in proto_counts().items():
        require(wrapper > 0, f"{name}: no launch in the tools' runs")
        require(launcher == wrapper, f"{name}: {launcher} kernel launches "
                f"for {wrapper} calls")
        recs[name]["launches"] = wrapper
    shutil.rmtree(runs_dir, ignore_errors=True)
    print(f"phase 10 launches in the tools' runs: "
          f"{ {n: c[0] for n, c in proto_counts().items()} }; the phase took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return recs


T0 = time.perf_counter()


# ---- phase 11: data parallel and FSDP (tokenreduction_tpu_torch/parallel/)
# DeiT-S topk@0.7 in amp from one seeded init, phase 5's recipe (AdamW,
# clip 1.0, EMA, drop-path 0.1, label smoothing), PAR_STEPS steps of PAR_B
# (two ranks: PAR_B / 2 each), run in child processes (python3
# chip_smoke.py --phase11 JOB DIR CARD), so that no process group outlives
# the phase in this process
PAR_B, PAR_STEPS, PAR_LR = 256, 3, 1e-3
# the train CLI with --fsdp --world_size 1: one epoch of PAR_CLI_N
# synthetic images at PAR_B (2 steps), then validate on its checkpoint
PAR_CLI_N = 512
# the collectives of the parallel path, each probed on a CUDA tensor over
# gloo (NCCL refuses two ranks on one device); the step of this recipe
# needs the first four, the last is mixup's partner exchange
PAR_COLLECTIVES = ("broadcast", "all_reduce", "all_gather_into_tensor",
                   "reduce_scatter", "batch_isend_irecv")
PAR_STEP_COLLECTIVES = PAR_COLLECTIVES[:4]
# two ranks of PAR_B / 2 against one of PAR_B: each rank's amp loss is a
# bf16 scalar (the logits' dtype), so the losses agree to a bf16 ulp,
# 2^-7 relative; the bf16 weight gradients of other batch splits are
# summed in other orders and rounded to bf16, so the norms agree to
# PAR_NORM_BOUND, and each param to PAR_PARAM_BOUND of its leaf's max but
# for at most PAR_PARAM_SHARE of them (AdamW's g / (|g| + eps) where g is
# near 0), every param within AdamW's update range 2 lr a step
PAR_LOSS_BOUND, PAR_NORM_BOUND = 2.0 ** -7, 2e-2
PAR_PARAM_BOUND, PAR_PARAM_SHARE = 1e-3, 1e-2
# one rank's process group (NCCL on the card) and the CLI's device flags
PAR_BACKEND, PAR_DEVICE_ARGS = "nccl", []


def par_train(dp, rows, say) -> dict:
    """PAR_STEPS steps on ``rows`` of each global batch (None: all) over
    the data axis ``dp`` (None: the plain step); the losses, gradient
    norms, seconds a step (host clock around synchronised steps), the
    peak memory allocated and the whole params, EMA and moments."""
    settle()
    torch.cuda.reset_peak_memory_stats()
    name, kw = MODELS["topk@0.7"]
    model, _ = create_model(name, device=DEVICE, drop_path_rate=0.1,
                            generator=torch.Generator().manual_seed(1), **kw)
    opt, _ = create_optimizer(dict(model.named_parameters()),
                              OptimConfig(lr=PAR_LR, clip_grad=1.0,
                                          backbone_lr_scale=0.01),
                              lambda s: PAR_LR, [])
    state = init_train_state(model, opt, ema=True, device=DEVICE, dp=dp)
    step = make_train_step(
        model, label_smoothing_loss, opt,
        StepConfig(ema_decay=0.99996, amp=True),
        torch.Generator(device=DEVICE).manual_seed(5), dp=dp)
    data = torch.Generator(device=DEVICE).manual_seed(3)
    xs = torch.randn(PAR_STEPS, PAR_B, 3, 224, 224, generator=data,
                     device=DEVICE)
    ys = torch.randint(0, 1000, (PAR_STEPS, PAR_B), generator=data,
                       device=DEVICE)
    if rows is not None:
        xs, ys = xs[:, rows].contiguous(), ys[:, rows].contiguous()
    seconds, metrics = [], []
    for i in range(PAR_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, {"image": xs[i], "label": ys[i]})
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append(torch.stack([m["loss"], m["grad_norm"]]))
    peak = torch.cuda.max_memory_allocated()
    whole = (dp.full_state(state, opt) if dp is not None and dp.fsdp else
             dict(params=state.params, ema_params=state.ema_params,
                  opt_state=state.opt_state))
    metrics = torch.stack(metrics).cpu()
    require(bool(torch.isfinite(metrics).all()),
            f"phase 11: non-finite metrics {metrics.tolist()}")
    return dict(metrics=metrics, seconds=seconds, peak=peak,
                split=len(dp.split()) if dp is not None else 0,
                **{k: v for k, v in whole.items()})


def par_line(label: str, run: dict, card: str) -> str:
    timed = run["seconds"][1:]
    ms = 1e3 * sum(timed) / len(timed)
    return (f"phase 11 {label}: {ms:.2f} ms/step over steps 2-{PAR_STEPS} "
            f"(first {1e3 * run['seconds'][0]:.1f} ms), peak memory "
            f"allocated {run['peak'] / 2**30:.2f} GiB, {run['split']} "
            f"leaves split; losses "
            f"{[round(v, 5) for v in run['metrics'][:, 0].tolist()]}, grad "
            f"norms {[round(v, 4) for v in run['metrics'][:, 1].tolist()]} on "
            f"{card}")


def same_state(a: dict, b: dict) -> list:
    """The names of the tensors where two runs' states differ in a bit."""
    bad = [] if torch.equal(a["metrics"], b["metrics"]) else ["metrics"]
    for key in ("params", "ema_params"):
        bad += [f"{key} {n}" for n, t in a[key].items()
                if not torch.equal(t, b[key][n])]
    for part, tensors in a["opt_state"].items():
        bad += [f"{part} {n}" for n, t in tensors.items()
                if not torch.equal(t, b["opt_state"][part][n])]
    return bad


def to_host(run: dict) -> dict:
    return {k: ({n: t.detach().cpu() for n, t in v.items()}
                if k in ("params", "ema_params") else v)
            for k, v in run.items() if k != "opt_state"}


def par_world1(root: pathlib.Path, card: str, say) -> dict:
    """One rank on NCCL: the plain step, DDP and FSDP from one init, bit
    for bit; then the train CLI with --fsdp --world_size 1 in the same
    process group and validate on its checkpoint."""
    import torch.distributed as dist

    from tokenreduction_tpu_torch.parallel import DataParallel

    dist.init_process_group(PAR_BACKEND, init_method="env://",
                            world_size=1, rank=0)
    total = dict.fromkeys([*WRAPPERS, *LAUNCHERS], 0)
    plain = par_train(None, None, say)
    say(par_line(f"world 1 plain step b{PAR_B}", plain, card))
    want = {k: PAR_STEPS * n for k, n in PER_TRAIN_STEP["topk@0.7"].items()}
    for label, fsdp in (("ddp", False), ("fsdp", True)):
        reset_counts()
        run = par_train(DataParallel(fsdp=fsdp), None, say)
        got = {**counts(), **launcher_counts()}
        require({k: got[k] for k in want} == want,
                f"phase 11 world 1 {label}: launches {got}, not {want}")
        for k, n in got.items():
            total[k] += n
        bad = same_state(plain, run)
        require(not bad, f"phase 11 world 1 {label}: differs from the plain "
                f"step in {len(bad)} tensors, e.g. {bad[:5]}")
        say(par_line(f"world 1 nccl {label} b{PAR_B}", run, card)
            + "; losses, gradient norms, masters, EMA and moments bit-equal "
            "to the plain step's; launches "
            f"{ {k: n for k, n in got.items() if n} }")
        del run
    torch.save(to_host(plain), root / "plain.pt")
    del plain

    run = root / "cli"
    t0 = time.perf_counter()
    rec = cli_run(CLI_MODEL + [
        "--batch-size", str(PAR_B), "--synthetic-n", str(PAR_CLI_N),
        "--epochs", "1", "--fsdp", "--world_size", "1", "--use_amp",
        "--num-workers", str(cli_workers()), "--output_dir", str(run)]
        + PAR_DEVICE_ARGS)
    seconds = time.perf_counter() - t0
    rows = read_log(run)
    require([r["epoch"] for r in rows] == [0] and all(
        math.isfinite(r[k]) for r in rows for k in ("train_loss", "test_loss"))
        and (run / "best_checkpoint" / "tree.pt").is_file(),
        f"phase 11 train CLI --fsdp: rows {rows}")
    got = cli_train_launches("train CLI --fsdp", rec, PAR_CLI_N // PAR_B,
                             2 * -(-PAR_CLI_N // PAR_B), True, phase="11")
    for k, n in rec.counts.items():
        total[k] += n
    say(f"phase 11 train CLI --fsdp --world_size 1 (NCCL) b{PAR_B} over "
        f"{PAR_CLI_N} images: {seconds:.1f} s the run, train img/s "
        f"{[round(r['images_per_sec'], 1) for r in rows]}, losses "
        f"{[round(v, 4) for v in torch.stack(rec.losses).tolist()]}, acc1 "
        f"{[r['test_acc1'] for r in rows]}; launches {got} on {card}")
    reset_counts()
    from tokenreduction_tpu_torch.evaluation import validate

    data = validate.main(["--checkpoint", str(run), "--dataset", "synthetic",
                          "--synthetic-n", str(CLI_VALIDATE_N), "-b",
                          str(PAR_B), "--input-size", "224"]
                         + PAR_DEVICE_ARGS)
    torch.cuda.synchronize()
    got = {**counts(), **launcher_counts()}
    for k, n in got.items():
        total[k] += n
    n_img = len([k for k in data if k.startswith("synthetic_")])
    require(n_img == CLI_VALIDATE_N and got["gemm_tf32"] > 0,
            f"phase 11 validate: {n_img} images, launches {got}")
    say(f"phase 11 validate on the --fsdp checkpoint: Acc@1 "
        f"{data['Top1-Acc']} over {n_img} images; launches "
        f"{ {k: n for k, n in got.items() if n} }")
    dist.destroy_process_group()
    return {"counts": total}


# one collective of PAR_COLLECTIVES on a CUDA tensor over gloo, two ranks
# on the card; a rank prints RESULT when its collective returned. A gloo
# collective that is not CUDA-aware can abort its process (writev from a
# device pointer), so each runs in processes of its own
PAR_PROBE = """
import datetime, json, os, sys
import torch
import torch.distributed as dist
name, rank = sys.argv[1], int(os.environ["RANK"])
dist.init_process_group("gloo", init_method="env://", world_size=2,
                        rank=rank, timeout=datetime.timedelta(seconds=30))
x = torch.arange(4.0, device="cuda") + rank
if name == "broadcast":
    dist.broadcast(x, 0)
elif name == "all_reduce":
    dist.all_reduce(x)
elif name == "all_gather_into_tensor":
    dist.all_gather_into_tensor(x.new_empty(8), x)
elif name == "reduce_scatter":
    fn = getattr(dist, "reduce_scatter_single", None) or \\
        dist.reduce_scatter_tensor
    fn(x.new_empty(2), x)
else:
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.clone(), 1 - rank),
            dist.P2POp(dist.irecv, x.new_empty(4), 1 - rank)]):
        req.wait()
torch.cuda.synchronize()
dist.destroy_process_group()
print("RESULT " + json.dumps({"ok": True}), flush=True)
"""


def par_probe() -> dict:
    """Each collective of the parallel path on CUDA tensors over gloo, two
    ranks on the one card, all probes at once: "ok", or how the ranks
    failed (the last error line of their output)."""
    import concurrent.futures
    import sys

    from tokenreduction_tpu_torch.parallel.launch import spawn

    def one(name):
        try:
            spawn(2, [sys.executable, "-c", PAR_PROBE, name], timeout=120)
            return "ok"
        except RuntimeError as e:  # the probe's answer, printed
            err = [ln.strip() for ln in str(e).splitlines()
                   if "Error" in ln or "what()" in ln or "exit" in ln]
            return "refused: " + " | ".join(err[-2:])[:300]

    with concurrent.futures.ThreadPoolExecutor(len(PAR_COLLECTIVES)) as ex:
        return dict(zip(PAR_COLLECTIVES, ex.map(one, PAR_COLLECTIVES)))


def par_pair(root: pathlib.Path, card: str, say) -> dict:
    """Two ranks on the one card over gloo (run when gloo took CUDA
    tensors for every collective): DDP and FSDP at two b128 ranks."""
    import datetime
    import os

    import torch.distributed as dist

    from tokenreduction_tpu_torch.parallel import DataParallel, global_order

    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method="env://", world_size=2,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    out = {"counts": {}}
    rows = torch.as_tensor(global_order(2, 1, PAR_B // 2)[
        rank * PAR_B // 2:(rank + 1) * PAR_B // 2], device=DEVICE)
    want = {k: PAR_STEPS * n
            for k, n in PER_TRAIN_STEP["topk@0.7"].items()}
    for label, fsdp in (("ddp", False), ("fsdp", True)):
        reset_counts()
        run = par_train(DataParallel(fsdp=fsdp), rows, say)
        got = {**counts(), **launcher_counts()}
        require({k: got[k] for k in want} == want,
                f"phase 11 two ranks {label} rank {rank}: launches "
                f"{got}, not {want}")
        out["counts"][label] = got
        if rank == 0:
            torch.save(to_host(run), root / f"pair_{label}.pt")
            say(par_line(f"two ranks (gloo, one card) {label} "
                         f"2 x b{PAR_B // 2}", run, card))
        del run
    dist.destroy_process_group()
    return out


def par_against_one(label: str, got: dict, want: dict):
    """The two-rank run against the one-rank plain run (PAR_*_BOUND)."""
    m, w = got["metrics"], want["metrics"]
    rel = ((m - w).abs() / w.abs()).amax(0).tolist()
    require(rel[0] <= PAR_LOSS_BOUND and rel[1] <= PAR_NORM_BOUND,
            f"phase 11 two ranks {label}: losses or norms {m.tolist()} "
            f"against {w.tolist()}")
    worst, far, n = 0.0, 0, 0
    for key in ("params", "ema_params"):
        for name, t in want[key].items():
            gap = (got[key][name] - t).abs()
            worst = max(worst, float(gap.max()))
            far += int((gap > PAR_PARAM_BOUND * float(t.abs().max())).sum())
            n += t.numel()
    require(worst <= 2.01 * PAR_LR * PAR_STEPS and far <= PAR_PARAM_SHARE * n,
            f"phase 11 two ranks {label}: {far} of {n} params beyond "
            f"{PAR_PARAM_BOUND} of their leaf's max, the worst {worst}")
    return (f"losses and grad norms within {rel[0]:.2e} and {rel[1]:.2e} "
            f"relative of the one-rank b{PAR_B} step's, {far} of {n} params "
            f"and EMA beyond {PAR_PARAM_BOUND} of their leaf's max, the "
            f"largest gap {worst:.3e}")


def phase_parallel(card: str) -> dict:
    """Phase 11 (see the module docstring). Returns the launch counts of
    its runs, summed over the child processes."""
    import sys

    from tokenreduction_tpu_torch.parallel.launch import spawn

    root = pathlib.Path(__file__).resolve().parent / "build" / "phase11"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    total = dict.fromkeys([*WRAPPERS, *LAUNCHERS], 0)
    for job, world in (("world1", 1), ("pair", 2)):
        if job == "pair":
            probe = par_probe()
            print(f"phase 11 probe: gloo on CUDA tensors, two ranks on the "
                  f"card (torch {torch.__version__}): " + "; ".join(
                      f"{k} {v}" for k, v in probe.items()), flush=True)
            if any(probe[k] != "ok" for k in PAR_STEP_COLLECTIVES):
                print("phase 11 two ranks on one card: not run (gloo "
                      "refuses a collective of the step on CUDA tensors, "
                      "above); the cross-rank evidence is the CPU tests' "
                      "(tests/test_torch_parallel.py)", flush=True)
                break
        results = spawn(world, [sys.executable, str(pathlib.Path(
            __file__).resolve()), "--phase11", job, str(root), card],
            timeout=600)
        for res in results:
            require(res is not None, f"phase 11 {job}: a rank printed no "
                    "result")
            for line in res["lines"]:
                print(line, flush=True)
        if job == "world1":
            for k, n in results[0]["counts"].items():
                total[k] += n
            continue
        want = torch.load(root / "plain.pt", weights_only=False)
        for label in ("ddp", "fsdp"):
            got = torch.load(root / f"pair_{label}.pt", weights_only=False)
            print(f"phase 11 two ranks {label} against one rank: "
                  + par_against_one(label, got, want), flush=True)
            for r in results:
                for k, n in r["counts"][label].items():
                    total[k] += n
    shutil.rmtree(root, ignore_errors=True)
    return total


def par_child(job: str, root: str, card: str):
    """A child of phase 11: prints ``RESULT {json}`` with its lines;
    ``card``: the parent's name and power limit of the card."""
    lines = []

    def say(msg):
        lines.append(msg)

    root = pathlib.Path(root)
    out = (par_world1 if job == "world1" else par_pair)(root, card, say)
    print("RESULT " + json.dumps({"lines": lines, **out}), flush=True)


# ---- phase 12: the attention above 256 tokens (the wide kernels)
# DeiT's 384-px finetunes: 24 x 24 patches and CLS, N = 577
WIDE_PX = 384
# (heads, N) of the launches held alone: DeiT-S's and DeiT-B's heads at
# 272 px (290), 384 px (577), 512 px (1025) and one token past the
# single-pass kernels (257)
WIDE_SHAPES = ((6, 257), (6, 290), (6, 577), (6, 1025), (12, 577),
               (12, 1025))
# the rectangular attention's (heads, kept rows M, keys N): ATS@0.7's first
# sampling block at 384 px (404 samples and CLS), a smaller sample, and
# more keys than rows at 272 px
WIDE_RECT = ((6, 405, 577), (6, 300, 577), (6, 13, 290), (12, 405, 577))
# the record shapes (B = 256, H = 6): the kernels line's ms, bound, plain
# and SDPA
WIDE_RECORD = (6, 577)
WIDE_B = {torch.float32: 32, torch.bfloat16: 256}
# images a chunk of the plain versions (their [B, H, N, N] fp32 tensors)
WIDE_CHUNK = 16
# the variants whose plain version is timed at WIDE_RECORD; the first of a
# launcher's gives its record
WIDE_PLAIN_TIMED = ("forward, row0 + colsum", "forward, normalised P, row0, "
                    "stats", "backward, row0 cotangent", "rect M=405")
# the wide kernels' launchers (in LAUNCHERS)
WIDE_LAUNCHERS = ("attention_wide", "rect_attention_wide",
                  "attention_wide_bwd", "attention_wide_tf32",
                  "rect_attention_wide_tf32", "attention_wide_bwd_tf32")
ATTENTION_WIDE = "tokenreduction_tpu_torch/csrc/attention_wide_sm90.cu"
ATTENTION_WIDE_TF32 = "tokenreduction_tpu_torch/csrc/attention_wide_tf32.cu"
ATTENTION_WIDE_TF32_BWD = \
    "tokenreduction_tpu_torch/csrc/attention_wide_tf32_bwd.cu"
# each wide kernel's source and the TPU kernel its record names
WIDE_SOURCES = {
    "attention_wide": (ATTENTION_WIDE, ATTENTION_REPLACES["short_attention"]),
    "rect_attention_wide": (ATTENTION_WIDE,
                            ATTENTION_REPLACES["rect_attention"]),
    "attention_wide_bwd": (ATTENTION_WIDE,
                           ATTENTION_REPLACES["short_attention_bwd"]),
    "attention_wide_tf32": (ATTENTION_WIDE_TF32,
                            ATTENTION_REPLACES["short_attention"]),
    "rect_attention_wide_tf32": (ATTENTION_WIDE_TF32,
                                 ATTENTION_REPLACES["rect_attention"]),
    "attention_wide_bwd_tf32": (ATTENTION_WIDE_TF32_BWD,
                                ATTENTION_REPLACES["short_attention_bwd"]),
}
# phase 12's 384-px eval cells (bf16 b256) and their reductions
WIDE_EVAL = ("dense", "topk@0.7", "tome@0.7", "ats@0.7", "heuristic",
             "evit@0.7", "dyvit@0.7")
WIDE_FP32 = ("dense", "topk@0.7", "ats@0.7")
WIDE_FP32_B = 4
WIDE_TRAIN = "topk@0.7"
WIDE_TRAIN_STEPS = 4
WIDE_GRAD_B = 2


def wide_counts() -> dict:
    return {name: n for name, n in launcher_counts().items()
            if name in WIDE_LAUNCHERS}


def wide_smem_lines(prefix: str):
    for n in (290, 577, 1025, 2048):
        smem = _build.attention_wide_smem(n)
        print(f"{prefix} attention_wide N={n}: dynamic shared memory a block: "
              f"bf16 forward {smem['forward']} bytes (384 threads), "
              f"rectangular {smem['rect']}, backward dQ {smem['dq']}, dK dV "
              f"{smem['dkv']} (128 threads); fp32 forward {smem['tf32']}, "
              f"backward {smem['tf32_bwd']} a launch (128 threads)",
              flush=True)


def chunked(fn, B: int):
    """fn over batch slices of WIDE_CHUNK images, each output concatenated
    along dim 0 (so that the plain versions' [B, H, N, N] tensors stay a
    chunk's size)."""
    parts = [as_list(fn(slice(i, i + WIDE_CHUNK)))
             for i in range(0, B, WIDE_CHUNK)]
    return [torch.cat(outs) for outs in zip(*parts)]


def wide_ms(fn, runs: int = 5) -> float:
    """CUDA-event time of one of ten back-to-back launches of fn (median
    of ``runs`` runs), in ms."""
    def ten():
        for _ in range(10):
            fn()
    return cuda_ms(ten, runs=runs, warmup=1) / 10


def wide_cases(dtype, H: int, N: int, gen):
    """(launcher, label, run, [(output, got or a call that reads it, want
    call over a batch slice)], flops, bytes, SDPA call) of each wide
    variant at B images (WIDE_B) of N tokens and H heads of 64: the eval
    forward with row0 and colsum (also with ToMe's bias, and with a mask
    that has fully masked rows), with row0 alone and with neither, in
    bf16 the training branch's normalised-P
    forward with its statistics, and the backward of the branch (row0
    cotangent), of ToMe's core (bias, both cotangents, dbias) and of a
    masked core. bytes: each input read once, each output written once."""
    B, Dh = WIDE_B[dtype], 64 * H
    dev_gen = torch.Generator(device=DEVICE).manual_seed(H * 10000 + N)
    bf16 = dtype == torch.bfloat16

    def rn(*shape, dt=dtype):
        return torch.randn(*shape, generator=dev_gen, device=DEVICE).to(dt)

    qkv = rn(B, N, 3 * Dh)
    q, k, v = packed_heads(qkv, H)
    bias = log_sizes(B, N, gen, torch.float32)
    mask = token_mask(B, N, gen)
    merged = torch.empty(B, N, Dh, device=DEVICE, dtype=dtype)
    row0 = torch.empty(B, H, N, device=DEVICE)
    colsum = torch.empty_like(row0)
    stats = torch.empty(B, H, N, 2, device=DEVICE)
    E, vec = (2 if bf16 else 4), 4 * B * H * N
    io = E * 4 * B * N * Dh
    fwd_flops = 4 * B * N * N * Dh
    outs3 = ("merged heads", "row0", "colsum"), (merged, row0, colsum)
    launcher = "attention_wide" if bf16 else "attention_wide_tf32"
    forwards = [
        ("forward, row0 + colsum", {}, outs3,
         lambda sl: attention_ref(qkv[sl], H, SCALE), 2 * vec, None),
        ("forward, row0", dict(colsum=None), outs3[0][:2], outs3[1][:2],
         lambda sl: attention_ref(qkv[sl], H, SCALE)[:2], vec, None),
        # dense's halves and every block that does not reduce
        ("forward, no by-products", dict(row0=None, colsum=None),
         outs3[0][:1], outs3[1][:1],
         lambda sl: attention_ref(qkv[sl], H, SCALE)[:1], 0, None),
        ("forward, bias, row0 + colsum", dict(bias=bias), outs3,
         lambda sl: attention_ref(qkv[sl], H, SCALE, bias[sl]),
         2 * vec + 4 * B * N, float_mask(dtype, bias)),
        ("forward, mask, row0 + colsum", dict(mask=mask), outs3,
         lambda sl: attention_ref(qkv[sl], H, SCALE, mask=mask[sl]),
         2 * vec + B * N, float_mask(dtype, None, mask, mask))]
    for case in forwards:
        if len(case) == 6:
            label, kw, (names, outs), want, extra, lib_mask = case
        else:
            label, kw, names, outs, want, extra, lib_mask = case
        yield (launcher, label,
               lambda kw=kw: _build.short_attention(
                   qkv, merged, H, SCALE,
                   **{"row0": row0, "colsum": colsum, **kw}),
               list(zip(names, outs, range(3))), want, fwd_flops,
               io + extra,
               lambda m=lib_mask: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=m, scale=SCALE))
    dout, drow0 = rn(B, N, Dh), rn(B, H, N, dt=torch.float32)
    dcs = rn(B, H, N, dt=torch.float32)
    dqkv = torch.empty_like(qkv)
    bwd_flops = 10 * B * N * N * Dh  # S, dP, dV, dK, dQ
    bwd_io = E * 7 * B * N * Dh  # q, k, v, dout in; dq, dk, dv out
    dout_h = rn(B, N, H, 64).transpose(1, 2)
    grads = torch.empty(3, B, H, N, 64, device=DEVICE, dtype=dtype).unbind(0)
    dbias = torch.empty(B, H, N, device=DEVICE)
    if not bf16:
        # the fp32 backward (csrc/attention_wide_tf32_bwd.cu) from the fp32
        # forward's statistics: the branch's (#9, the row0 cotangent) and
        # the core's with every option (#11: bias, mask, both cotangents,
        # dbias)
        yield from wide_tf32_bwd_cases(qkv, merged, row0, stats, dout, drow0,
                                       dcs, dqkv, dout_h, grads, dbias, bias,
                                       mask, H, bwd_flops, bwd_io, vec)
        return
    yield (launcher, "forward, normalised P, row0 + colsum",
           lambda: _build.short_attention(qkv, merged, H, SCALE, row0=row0,
                                          colsum=colsum, norm_p=True),
           list(zip(("merged heads", "row0", "colsum"),
                    (merged, row0, colsum), range(3))),
           lambda sl: (attention_train_ref(qkv[sl], H, SCALE)[0],
                       *attention_ref(qkv[sl], H, SCALE)[1:]),
           fwd_flops, io + 2 * vec, lambda: F.scaled_dot_product_attention(
               q, k, v, scale=SCALE))
    yield (launcher, "forward, normalised P, row0, stats",
           lambda: _build.short_attention(qkv, merged, H, SCALE, row0=row0,
                                          stats=stats, norm_p=True),
           list(zip(("merged heads", "row0", "row max", "1/sum"),
                    (merged, row0, lambda: stats[..., 0],
                     lambda: stats[..., 1]), range(4))),
           lambda sl: (*attention_train_ref(qkv[sl], H, SCALE),
                       *stats_ref(q[sl], k[sl]).unbind(-1)),
           fwd_flops, io + vec, lambda: F.scaled_dot_product_attention(
               q, k, v, scale=SCALE))
    # the backward: the branch's (packed qkv, the row0 cotangent)
    _build.short_attention(qkv, merged, H, SCALE, row0=row0, stats=stats,
                           norm_p=True)
    yield ("attention_wide_bwd", "backward, row0 cotangent",
           lambda: _build.short_attention_bwd(qkv, merged, dout, drow0, dqkv,
                                              H, SCALE, stats=stats,
                                              row0=row0),
           [(n, lambda i=i: dqkv[..., i * Dh:(i + 1) * Dh], i)
            for i, n in enumerate(("dq", "dk", "dv"))],
           lambda sl: [attention_bwd_ref(qkv[sl], dout[sl], drow0[sl], H,
                                         SCALE)[..., i * Dh:(i + 1) * Dh]
                       for i in range(3)],
           bwd_flops, bwd_io + vec,
           sdpa_backward(q, k, v, merged_heads(dout, H)))
    # the core's, over [B, H, N, hd] views: ToMe's (bias, both cotangents,
    # dbias) and a masked one (no cotangents)
    for label, fw, kw, extra, lib_mask in (
            ("backward, bias, colsum cotangent, dbias", dict(bias=bias),
             dict(bias=bias, drow0=drow0, dcs=dcs, dbias=dbias),
             3 * vec + 4 * B * N, float_mask(dtype, bias)),
            ("backward, mask", dict(mask=mask), dict(mask=mask), B * N,
             float_mask(dtype, None, mask, mask))):
        out, r0, _, st = core_forward(q, k, v, **fw)
        names = ("dq", "dk", "dv", "dbias")[:4 if "dbias" in kw else 3]

        def want(sl, kw=kw, n=len(names)):
            return attention_core_train_bwd_ref(
                q[sl], k[sl], v[sl], None if "bias" not in kw else bias[sl],
                dout_h[sl], None if "drow0" not in kw else drow0[sl],
                None if "dcs" not in kw else dcs[sl], SCALE,
                None if "mask" not in kw else mask[sl])[:n]

        yield ("attention_wide_bwd", label,
               lambda out=out, r0=r0, st=st, kw=kw:
               _build.short_attention_bwd_heads(q, k, v, out, dout_h, *grads,
                                                SCALE, stats=st, row0=r0,
                                                **kw),
               list(zip(names, (*grads, dbias), range(4))), want, bwd_flops,
               bwd_io + extra, sdpa_backward(q, k, v, dout_h, lib_mask))


def wide_tf32_bwd_cases(qkv, merged, row0, stats, dout, drow0, dcs, dqkv,
                        dout_h, grads, dbias, bias, mask, H, flops, io, vec):
    """The fp32 backward's cases in the form of wide_cases: #9's (the
    packed qkv, the row0 cotangent; the statistics of a normalised-P
    forward) and #11's with every option (bias, mask, both cotangents,
    dbias; the statistics of the core's forward)."""
    q, k, v = packed_heads(qkv, H)
    Dh = 64 * H
    _build.short_attention(qkv, merged, H, SCALE, row0=row0, stats=stats,
                           norm_p=True)
    yield ("attention_wide_bwd_tf32", "backward, row0 cotangent",
           lambda: _build.short_attention_bwd(qkv, merged, dout, drow0, dqkv,
                                              H, SCALE, stats=stats,
                                              row0=row0),
           [(n, lambda i=i: dqkv[..., i * Dh:(i + 1) * Dh], i)
            for i, n in enumerate(("dq", "dk", "dv"))],
           lambda sl: [attention_bwd_ref(qkv[sl], dout[sl], drow0[sl], H,
                                         SCALE)[..., i * Dh:(i + 1) * Dh]
                       for i in range(3)],
           flops, io + vec, sdpa_backward(q, k, v, merged_heads(dout, H)))
    out, r0, _, st = core_forward(q, k, v, bias=bias, mask=mask)
    kw = dict(bias=bias, mask=mask, drow0=drow0, dcs=dcs, dbias=dbias)
    yield ("attention_wide_bwd_tf32",
           "backward, bias, mask, both cotangents, dbias",
           lambda: _build.short_attention_bwd_heads(
               q, k, v, out, dout_h, *grads, SCALE, stats=st, row0=r0, **kw),
           list(zip(("dq", "dk", "dv", "dbias"), (*grads, dbias), range(4))),
           lambda sl: attention_core_train_bwd_ref(
               q[sl], k[sl], v[sl], bias[sl], dout_h[sl], drow0[sl], dcs[sl],
               SCALE, mask[sl]),
           flops, io + 3 * vec + 4 * qkv.shape[0] * qkv.shape[1],
           sdpa_backward(q, k, v, dout_h,
                         float_mask(torch.float32, bias, mask, mask)))


def wide_rect_cases(dtype, gen):
    """(case, H, N) of the rectangular variant at WIDE_RECT, each case in
    the form of wide_cases; the padded slots equal to the CLS slot and the
    dead slot uniform (check_rect_rows) first."""
    B = WIDE_B[dtype]
    launcher = ("rect_attention_wide" if dtype == torch.bfloat16
                else "rect_attention_wide_tf32")
    for H, M, N in WIDE_RECT:
        Dh = 64 * H
        dev_gen = torch.Generator(device=DEVICE).manual_seed(M * 1000 + N)
        qkv = torch.randn(B, N, 3 * Dh, generator=dev_gen,
                          device=DEVICE).to(dtype)
        mask = token_mask(B, N, gen)
        idx = kept_ids(B, N, M, mask, gen)
        ids = idx.to(torch.int32)
        merged = torch.empty(B, M, Dh, device=DEVICE, dtype=dtype)
        _build.short_attention(qkv, merged, H, SCALE, mask=mask, ids=ids)
        torch.cuda.synchronize()
        if H == HEADS:  # check_rect_rows reads DeiT-S's heads
            pads, dead = check_rect_rows(merged, qkv, idx, mask,
                                         f"M={M} N={N}")
            print(f"phase 12 rect M={M} N={N} {dtype}: {pads} padded slots "
                  f"equal to CLS, {dead} fully masked rows uniform",
                  flush=True)
        q, k, v = packed_heads(qkv, H)
        qg = torch.gather(q, 2, idx[:, None, :, None].expand(B, H, M, 64))
        yield (launcher, f"rect M={M}",
               lambda qkv=qkv, merged=merged, mask=mask, ids=ids, H=H:
               _build.short_attention(qkv, merged, H, SCALE, mask=mask,
                                      ids=ids),
               [("merged heads", merged, 0)],
               lambda sl, qkv=qkv, idx=idx, mask=mask, H=H: rect_attention_ref(
                   qkv[sl], idx[sl], mask[sl], H, SCALE),
               4 * B * M * N * Dh,
               (2 if dtype == torch.bfloat16 else 4)
               * (2 * B * N * Dh + 2 * B * M * Dh) + 4 * B * M + B * N,
               lambda qg=qg, k=k, v=v, m=float_mask(
                   dtype, None, torch.gather(mask, 1, idx), mask):
               F.scaled_dot_product_attention(qg, k, v, attn_mask=m,
                                              scale=SCALE)), H, N


def wide_kernel_checks(card: str) -> dict:
    """Each wide launch alone against its plain version (each output within
    LAUNCH_BOUND of its own max: 1e-2 bf16, 1e-4 fp32), bit-equal on a
    second launch, with its ms per launch, bound and SDPA's ms; the plain
    composition's ms at WIDE_RECORD. Returns the kernels' records."""
    gen = torch.Generator().manual_seed(12)
    rec = {}

    def cases():  # one shape's tensors at a time, in the cases' order
        for dtype in (torch.bfloat16, torch.float32):
            for H, N in WIDE_SHAPES:
                for case in wide_cases(dtype, H, N, gen):
                    yield case, H, N
            yield from wide_rect_cases(dtype, gen)

    for (launch, label, run, outs, want_fn, flops, nbytes, library), H, N in \
            cases():
        run()
        torch.cuda.synchronize()
        got = [(name, g() if callable(g) else g, i) for name, g, i in outs]
        first = [t.clone() for _, t, _ in got]
        B = got[0][1].shape[0]
        want = chunked(want_fn, B)
        errs, worst = [], 0.0
        for name, g, i in got:
            abs_err, rel = rel_err(g, want[i])
            bound_ = LAUNCH_BOUND[g.dtype]
            require(rel <= bound_, f"{launch} {label} H={H} N={N} {name}: "
                    f"error {rel:.3e} of its max|plain| > bound {bound_:.0e}")
            errs.append(f"{name} {abs_err:.3e} ({rel:.2e})")
            worst = max(worst, abs_err)
        del want
        run()
        torch.cuda.synchronize()
        again = [g() if callable(g) else g for _, g, _ in outs]
        require(all(torch.equal(a, b) for a, b in zip(first, again)),
                f"{launch} {label} H={H} N={N}: a second launch differs")
        dtype = got[0][1].dtype
        ms, lib_ms = wide_ms(run), wide_ms(library)
        peak = PEAK_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS / 3
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        tag = f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} B={B} H={H} N={N}"
        plain_ms = None
        # the fp32 backward's record comes from wide_tf32_bwd_record
        if ((H, N) == WIDE_RECORD and label in WIDE_PLAIN_TIMED
                and launch != "attention_wide_bwd_tf32"):
            plain_ms = wide_ms(lambda: chunked(want_fn, B), runs=3)
            rec.setdefault(launch, dict(
                shape=f"{tag} {label}", ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                max_abs_err=worst))
        plain = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
        print(f"phase 12 {launch} {label} {tag}: {', '.join(errs)} of max; a "
              f"second launch bit-equal; kernel {ms:.4f} ms per launch "
              f"({flops / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.4f} ms "
              f"({bound_by}), SDPA {lib_ms:.4f} ms{plain} on {card}",
              flush=True)
    return rec


def wide_block_checks(card: str):
    """The wrappers above 256 tokens, whole blocks against their plain
    versions (bf16 B=256 within 2e-2 of max|plain|, fp32 B=32 1e-4): #2
    with ToMe's bias and the head-mean keys at N=577, and with DyViT's idx
    prologue 577 -> 404; #8 at ATS@0.7's 405 x 577."""
    gen = torch.Generator().manual_seed(13)
    for dtype in (torch.bfloat16, torch.float32):
        B, N = WIDE_B[dtype], 577
        p = block_params(dtype, gen)
        x = torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)
        bias = log_sizes(B, N, gen, torch.float32)
        idx = torch.stack([torch.cat([torch.zeros(1, dtype=torch.long),
                                      1 + torch.randperm(N - 1, generator=gen)[
                                          :403]]) for _ in range(B)]).to(DEVICE)
        mask = token_mask(B, N, gen)
        kept = kept_ids(B, N, 405, mask, gen)
        qkv = ln_qkv(x, *(p[n] for n in ATTN[:4]), eps=EPS)
        cases = (
            ("fused_block_attention bias + keys",
             lambda: fused_block_attention(x, *(p[n] for n in ATTN), HEADS,
                                           SCALE, bias=bias, want_keys=True),
             lambda: fused_block_attention_ref(x, *(p[n] for n in ATTN),
                                               HEADS, SCALE, bias=bias,
                                               want_keys=True)),
            ("fused_block_attention idx 577->404",
             lambda: fused_block_attention(x, *(p[n] for n in ATTN), HEADS,
                                           SCALE, idx=idx),
             lambda: fused_block_attention_ref(take_tokens(x, idx),
                                               *(p[n] for n in ATTN), HEADS,
                                               SCALE)),
            ("fused_rect_block 405x577",
             lambda: fused_rect_block(qkv, x, kept, mask, p["wproj"],
                                      p["bproj"], HEADS, SCALE),
             lambda: fused_rect_block_ref(qkv, x, kept, mask, p["wproj"],
                                          p["bproj"], HEADS, SCALE)))
        for label, run, plain in cases:
            got, want = as_list(run()), as_list(plain())
            errs = []
            for g, w in zip(got, want):
                _, rel = rel_err(g, w)
                require(rel <= BOUND[dtype], f"phase 12 {label} {dtype}: "
                        f"{rel:.3e} of max|plain| > {BOUND[dtype]:.0e}")
                errs.append(f"{rel:.2e}")
            print(f"phase 12 block {label} {dtype} B={B}: outputs within "
                  f"{', '.join(errs)} of max|plain| (bound "
                  f"{BOUND[dtype]:.0e}); {cuda_ms(run, runs=5, warmup=1):.4f} "
                  f"ms on {card}", flush=True)
        del p, x, qkv
        settle()


def wide_compositions(card: str):
    """The eager library composition of each wide row at H=6, N=577, by
    CUDA events (bf16 B=256; fp32 the forward at B=32, the backward at
    B=256): the forward (SDPA and the fp32 CLS row, no column mass:
    library_core), the backward (autograd through it with the row0
    cotangent), the rectangular 405 x 577 (the kept rows gathered, then
    SDPA with the pair mask: library_rect), and in bf16 #2 with the bias
    and keys and with the idx prologue 577 -> 404 and #8 at 405 x 577 as
    whole blocks (LayerNorm, linear, SDPA, proj, residual), with the whole
    blocks' bounds (their products at 989 TFLOP/s, or each input read and
    each output written once at 3.35 TB/s)."""
    gen = torch.Generator().manual_seed(14)
    H, N = WIDE_RECORD
    Dh = 64 * H
    for dtype, b_fwd in ((torch.bfloat16, TRAIN_B), (torch.float32,
                                                     WIDE_B[torch.float32])):
        qkv = torch.randn(TRAIN_B, N, 3 * Dh, generator=gen).to(DEVICE, dtype)
        mask = token_mask(TRAIN_B, N, gen)
        kept = kept_ids(TRAIN_B, N, 405, mask, gen)
        with torch.no_grad():
            qf, kf, vf = (t[:b_fwd] for t in packed_heads(qkv, H))
            fwd = wide_ms(lambda: library_core(qf, kf, vf, SCALE))
            rect = wide_ms(lambda: library_rect(qkv[:b_fwd], kept[:b_fwd],
                                                mask[:b_fwd]))
        leaf = qkv.detach().requires_grad_()
        q, k, v = packed_heads(leaf, H)
        with torch.enable_grad():
            o, row0, _ = library_core(q, k, v, SCALE)
        dout = torch.randn(o.shape, generator=gen).to(DEVICE, dtype)
        drow0 = torch.randn(row0.shape, generator=gen).to(DEVICE)
        bwd = wide_ms(lambda: torch.autograd.grad(
            (o, row0), (leaf,), (dout, drow0), retain_graph=True), runs=3)
        print(f"phase 12 composition {dtype} H={H} N={N}: forward (SDPA + "
              f"the CLS row) B={b_fwd} {fwd:.4f} ms, rectangular 405 x 577 "
              f"B={b_fwd} {rect:.4f} ms, backward through them with the row0 "
              f"cotangent B={TRAIN_B} {bwd:.4f} ms on {card}", flush=True)
        del qkv, leaf, q, k, v, o, row0, dout
    dtype, B = torch.bfloat16, TRAIN_B
    p = block_params(dtype, gen)
    attn = [p[n] for n in ATTN]
    x = torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)
    bias = log_sizes(B, N, gen, torch.float32)
    idx = torch.stack([torch.cat([torch.zeros(1, dtype=torch.long),
                                  1 + torch.randperm(N - 1, generator=gen)[
                                      :403]]) for _ in range(B)]).to(DEVICE)
    mask = token_mask(B, N, gen)
    kept = kept_ids(B, N, 405, mask, gen)
    with torch.no_grad():
        qkv = ln_qkv(x, *attn[:4], eps=EPS)
        runs = (
            ("#2 bias + keys", N, N, lambda: library_block_attention(
                x, *attn, HEADS, SCALE, bias=bias, want_keys=True)),
            ("#2 idx 577 -> 404", 404, 404, lambda: library_block_attention(
                x, *attn, HEADS, SCALE, idx=idx)),
            ("#8 405 x 577", 405, N, lambda: take_tokens(x, kept) + F.linear(
                library_rect(qkv, kept, mask), p["wproj"], p["bproj"])))
        for label, M, K, run in runs:
            ms = wide_ms(run)
            if label.startswith("#8"):  # qkv in: the attention and proj
                flops = 4 * B * M * N * D + 2 * B * M * D * D
                nbytes = 2 * (3 * B * N * D + 2 * B * M * D) + B * N
            else:  # LN, qkv, attention, proj on K rows; x in, out, by-products
                flops = 2 * B * K * D * 4 * D + 4 * B * K * K * D
                nbytes = 2 * (2 * B * K * D) + 8 * B * HEADS * K
                if "keys" in label:
                    nbytes += 2 * B * K * 64 + 4 * B * K
            t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
            print(f"phase 12 composition {label} bf16 B={B}: {ms:.4f} ms "
                  f"(LayerNorm, linear, SDPA, proj, residual as library "
                  f"calls); the block's bound {max(t_ops, t_bytes) * 1e3:.4f} "
                  f"ms ({'operations' if t_ops >= t_bytes else 'bytes'}) on "
                  f"{card}", flush=True)
    del p, x, qkv
    settle()


class PlainAttentionCount:
    """Counts the plain attention's calls (attention_probs_ref, by the
    modules of the blocks) while it is entered."""

    def __enter__(self):
        self.calls = 0
        self.orig = (layers.attention_probs_ref, ats_model.attention_probs_ref)

        def counted(*a, **kw):
            self.calls += 1
            return self.orig[0](*a, **kw)

        layers.attention_probs_ref = counted
        ats_model.attention_probs_ref = counted
        return self

    def __exit__(self, *exc):
        layers.attention_probs_ref, ats_model.attention_probs_ref = self.orig


class SingleWidthGate:
    """PR 22's gate while entered: every attention half above 256 tokens,
    eval or training, on the plain composition (the blocks' width limit
    set to SHORT_ATTENTION_MAX_N)."""

    def __enter__(self):
        self.orig = layers.ATTENTION_MAX_N
        layers.ATTENTION_MAX_N = SHORT_ATTENTION_MAX_N
        return self

    def __exit__(self, *exc):
        layers.ATTENTION_MAX_N = self.orig


def library_block_attention(x, ls, lb, wqkv, bqkv, wproj, bproj, num_heads,
                            scale, *, eps=EPS, bias=None, mask=None, idx=None,
                            want_keys=False, want_row0=True, want_colsum=True):
    """fused_block_attention as eager library calls (LayerNorm, linear,
    SDPA): x + the branch, the fp32 CLS row where wanted, no column
    mass."""
    if idx is not None:
        x = take_tokens(x, idx)
    out = library_attention(x, ls, lb, wqkv, bqkv, wproj, bproj, num_heads,
                            scale, eps, bias, want_keys, mask)
    return (x + out[0], out[1] if want_row0 else None, None) + tuple(out[2:])


def wide_serve(label: str, batches: int = 3) -> tuple[float, dict, int]:
    """(img/s over batches 2-`batches` of SERVE_B bf16 images at WIDE_PX,
    the launches of the run, plain attention calls)."""
    settle()
    name, kw = MODELS[label]
    model, _ = create_model(name, device=DEVICE, img_size=WIDE_PX,
                            generator=torch.Generator().manual_seed(1), **kw)
    model = model.to(torch.bfloat16).eval()
    xs = torch.randn(batches, SERVE_B, 3, WIDE_PX, WIDE_PX,
                     generator=torch.Generator(device=DEVICE).manual_seed(3),
                     device=DEVICE).to(torch.bfloat16)
    seconds = []
    reset_counts()
    with torch.no_grad(), PlainAttentionCount() as plain:
        for x in xs:
            t0 = time.perf_counter()
            out = model(x)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            require(out.shape == (SERVE_B, 1000) and
                    bool(torch.isfinite(out).all()),
                    f"{label} {WIDE_PX} px: non-finite or misshapen logits")
    got = {**counts(), **launcher_counts()}
    return SERVE_B * (batches - 1) / sum(seconds[1:]), got, plain.calls


def wide_eval(card: str) -> dict:
    """The 384-px bf16 b256 eval cells (WIDE_EVAL): each on the wide
    kernels above 256 tokens and today's below (topk@0.7 577 -> 404 -> 283
    -> 198 crosses), no plain attention; img/s beside the attention halves
    as eager library calls (dense, topk@0.7) and beside the plain
    attention above 256 (PR 22's gate: dense). Returns the launches."""
    total = collections.Counter()
    for label in WIDE_EVAL:
        ips, got, plain = wide_serve(label)
        total.update(got)
        require(plain == 0, f"{label} {WIDE_PX} px: {plain} plain attention "
                "calls")
        require(got["fused_full_block"] == 0 or label == "topk@0.7"
                or label in ("dyvit@0.7", "evit@0.7"),
                f"{label} {WIDE_PX} px: a full block above 256 tokens")
        wide_ = got["attention_wide"] + got["rect_attention_wide"]
        require(wide_ > 0, f"{label} {WIDE_PX} px: no wide launch {got}")
        if label == "ats@0.7":
            require(got["rect_attention_wide"] > 0,
                    f"ATS {WIDE_PX} px: no wide rectangular launch {got}")
        if label == "topk@0.7":
            require(got["short_attention"] > 0 and got["fused_full_block"] > 0,
                    f"topk {WIDE_PX} px: the last stage (198 tokens) ran no "
                    f"single-pass kernel {got}")
        FORWARD_IPS[label, f"bf16 {WIDE_PX} px"] = ips
        print(f"phase 12 serve {label} bf16 b{SERVE_B} {WIDE_PX} px: {ips:.1f} "
              f"img/s over batches 2-3; launches "
              f"{ {k: n for k, n in got.items() if n} }; plain attention 0 "
              f"on {card}", flush=True)
    orig = layers.fused_block_attention
    layers.fused_block_attention = library_block_attention
    try:
        for label in ("dense", "topk@0.7"):
            ips, _, _ = wide_serve(label)
            print(f"phase 12 serve {label} bf16 b{SERVE_B} {WIDE_PX} px, the "
                  f"attention halves as eager library calls (SDPA): {ips:.1f} "
                  f"img/s on {card}", flush=True)
    finally:
        layers.fused_block_attention = orig
    with SingleWidthGate():
        ips, got, plain = wide_serve("dense")
    print(f"phase 12 serve dense bf16 b{SERVE_B} {WIDE_PX} px, the plain "
          f"attention above 256 tokens (PR 22's gate): {ips:.1f} img/s, "
          f"{plain} plain attention calls on {card}", flush=True)
    return total


def wide_fp32(card: str) -> dict:
    """fp32 eval at 384 px (WIDE_FP32, B=WIDE_FP32_B): logits within 1e-4
    of the CPU's, decisions equal (record_decisions). Returns the
    launches."""
    total = collections.Counter()
    for label in WIDE_FP32:
        settle()
        name, kw = MODELS[label]
        model, _ = create_model(name, device=DEVICE, img_size=WIDE_PX,
                                generator=torch.Generator().manual_seed(1),
                                **kw)
        model = model.eval()
        cpu_model = copy.deepcopy(model).cpu()
        rec, cpu_rec = record_decisions(model), record_decisions(cpu_model)
        x = torch.randn(WIDE_FP32_B, 3, WIDE_PX, WIDE_PX,
                        generator=torch.Generator().manual_seed(2))
        reset_counts()
        with torch.no_grad(), PlainAttentionCount() as plain:
            out = model(x.to(DEVICE))
        torch.cuda.synchronize()
        got = {**counts(), **launcher_counts()}
        total.update(got)
        with torch.no_grad():
            ref = cpu_model(x)
        err, rel = rel_err(out.cpu(), ref)
        require(rel <= 1e-4, f"{label} fp32 {WIDE_PX} px: logits {rel:.3e} "
                "of max|CPU| > 1e-4")
        require(plain.calls == 0 and got["attention_wide_tf32"] +
                got["rect_attention_wide_tf32"] > 0,
                f"{label} fp32 {WIDE_PX} px: launches {got}, plain "
                f"{plain.calls}")
        # phase 3's rule in fp32: topk's kept ids all in the CPU's kept
        # set, ATS's Kept_Tokens all equal in place
        kept, ref_kept = rec.get("Kept_Tokens", {}), cpu_rec.get(
            "Kept_Tokens", {})
        require(sorted(kept) == sorted(ref_kept), f"{label} fp32 {WIDE_PX} "
                f"px: decisions at {sorted(kept)}, the CPU's {sorted(ref_kept)}")
        n_all = sum(k.numel() for k in ref_kept.values())
        if label.startswith("topk"):
            n_same = sum(int(torch.isin(a, b).sum()) for i, k in
                         ref_kept.items() for a, b in zip(kept[i].cpu(), k))
            limit, what = KEPT_SET[torch.float32], "in the CPU's kept set"
        else:
            n_same = sum(int((kept[i].cpu() == k).sum())
                         for i, k in ref_kept.items())
            limit, what = ATS_SAME[torch.float32], "equal in place"
        require(n_same >= limit * n_all, f"{label} fp32 {WIDE_PX} px: only "
                f"{n_same}/{n_all} kept ids {what}")
        widths = "->".join(str(k.shape[1] + 1) for k in ref_kept.values())
        print(f"phase 12 fp32 {label} {WIDE_PX} px B={WIDE_FP32_B}: logits max "
              f"abs err {err:.3e} ({rel:.2e} of max|CPU|, bound 1e-4); "
              f"widths 577{'->' + widths if widths else ''}, kept ids "
              f"{what} {n_same}/{n_all} (bound {limit}); launches "
              f"{ {k: n for k, n in got.items() if n} } on {card}",
              flush=True)
    return total


def wide_train(card: str) -> dict:
    """The amp topk@0.7 step at b256, 384 px: ms/step and peak memory on
    the kernels (its launches counted) and with the plain attention above
    256 tokens (PR 22's gate); then one step's loss and gradients of dense
    and topk@0.7 at B=WIDE_GRAD_B against the CPU's fp32 ones, the CPU's
    step gathering the card's kept tokens. Returns the launches."""
    reset_counts()
    with PlainAttentionCount() as plain:
        seconds, losses_, _, extra = train_run(
            WIDE_TRAIN, WIDE_TRAIN_STEPS, img_size=WIDE_PX)
    got = {**counts(), **launcher_counts()}
    require(plain.calls == 0 and got["attention_wide_bwd"] > 0
            and got["attention_wide"] > 0 and got["short_attention_bwd"] > 0,
            f"train {WIDE_TRAIN} {WIDE_PX} px: launches {got}, plain "
            f"attention {plain.calls}")
    ms = 1e3 * statistics.mean(seconds[2:])
    print(f"phase 12 train {WIDE_TRAIN} bf16 amp b{TRAIN_B} {WIDE_PX} px: "
          f"{ms:.2f} ms/step over steps 3-{WIDE_TRAIN_STEPS} (first "
          f"{seconds[0] * 1e3:.1f} ms), peak memory allocated "
          f"{extra['peak'] / 2**30:.2f} GiB; losses "
          f"{[round(v, 4) for v in losses_.tolist()]}; launches "
          f"{ {k: n for k, n in got.items() if n} } on {card}", flush=True)
    with SingleWidthGate(), PlainAttentionCount() as plain:
        seconds, _, _, extra = train_run(WIDE_TRAIN, WIDE_TRAIN_STEPS,
                                         img_size=WIDE_PX)
    require(plain.calls > 0, "PR 22's gate: no plain attention ran")
    print(f"phase 12 train {WIDE_TRAIN} bf16 amp b{TRAIN_B} {WIDE_PX} px, "
          f"the plain attention above 256 tokens (PR 22's gate): "
          f"{1e3 * statistics.mean(seconds[2:]):.2f} ms/step, peak "
          f"memory allocated {extra['peak'] / 2**30:.2f} GiB, "
          f"{plain.calls} plain attention calls on {card}", flush=True)
    bound_ = TRAIN_BOUND[torch.bfloat16]
    for label in ("dense", WIDE_TRAIN):
        settle()
        name, kw = MODELS[label]
        model, _ = create_model(name, device=DEVICE, img_size=WIDE_PX,
                                generator=torch.Generator().manual_seed(1),
                                **kw)
        cpu_model = copy.deepcopy(model).cpu()
        kept = record_kept(model)
        cpu_kept = record_kept(cpu_model, follow=kept)
        gen = torch.Generator().manual_seed(2)
        x = torch.randn(WIDE_GRAD_B, 3, WIDE_PX, WIDE_PX, generator=gen)
        y = torch.randint(0, 1000, (WIDE_GRAD_B,), generator=gen)
        opt, _ = create_optimizer(dict(model.named_parameters()),
                                  OptimConfig(lr=1e-3), lambda s: 1e-3, [])
        state = init_train_state(model, opt, device=DEVICE)
        cpu_state = init_train_state(cpu_model, opt, device="cpu")
        model.train()
        cpu_model.train()
        loss, grads = loss_and_grads(model, label_smoothing_loss,
                                     state.params, x.to(DEVICE), y.to(DEVICE),
                                     StepConfig(amp=True))
        cpu_loss, cpu_grads = loss_and_grads(cpu_model, label_smoothing_loss,
                                             cpu_state.params, x, y,
                                             StepConfig())
        _, loss_rel = rel_err(loss.cpu().reshape(1), cpu_loss.reshape(1))
        require(loss_rel <= bound_["loss"], f"{label} {WIDE_PX} px amp: loss "
                f"{loss_rel:.3e} of the CPU's > {bound_['loss']:.0e}")
        # the CPU's own top-k rows that the card's ids replaced
        ties = sum(int((kept[i] != cpu_kept[i]).any(1).sum()) for i in kept)
        worst_name, worst = max(((n, rel_err(g.cpu(), cpu_grads[n])[1])
                                 for n, g in grads.items()),
                                key=lambda t: t[1])
        require(worst <= bound_["grads"], f"{label} {WIDE_PX} px amp: "
                f"gradient {worst_name} {worst:.3e} of max|CPU fp32| > "
                f"{bound_['grads']:.0e}")
        print(f"phase 12 train {label} bf16 amp B={WIDE_GRAD_B} {WIDE_PX} px "
              f"against the CPU's fp32: loss {loss.item():.6f} vs "
              f"{cpu_loss.item():.6f} ({loss_rel:.2e}, bound "
              f"{bound_['loss']:.0e}); worst gradient leaf {worst_name} "
              f"{worst:.2e} of its max|CPU| (bound {bound_['grads']:.0e}); "
              f"the CPU gathered the card's kept tokens ({ties} rows of its "
              "own top-k differed)", flush=True)
    return got


def wide_train_fp32(card: str) -> dict:
    """The fp32 topk@0.7 step at 384 px, b256 (the JAX CLI's default dtype)
    on the kernels, every attention half above 256 tokens on the wide fp32
    forward and backward and no plain attention: ms/step and peak memory,
    beside the single-width gate (the plain attention above 256); then
    one fp32 step's loss and gradients at B=WIDE_GRAD_B against the CPU's
    (1e-4 of max|CPU|), with no plain attention, of dense and of topk@0.7,
    whose CPU step gathers the card's kept tokens (the rows where its own
    top-k differs, by a near tie, are reported).
    Returns the launches of the step on the kernels."""
    reset_counts()
    with PlainAttentionCount() as plain:
        seconds, losses_, _, extra = train_run(
            WIDE_TRAIN, WIDE_TRAIN_STEPS, amp=False, img_size=WIDE_PX)
    total = {**counts(), **launcher_counts()}
    require(plain.calls == 0 and total["attention_wide_bwd_tf32"] > 0
            and total["attention_wide_tf32"] > 0
            and total["attention_bwd_tf32"] > 0,
            f"train {WIDE_TRAIN} fp32 {WIDE_PX} px: launches {total}, plain "
            f"attention {plain.calls}")
    kernel_ms, kernel_peak = 1e3 * statistics.mean(seconds[2:]), extra["peak"]
    print(f"phase 12 train {WIDE_TRAIN} fp32 b{TRAIN_B} {WIDE_PX} px: "
          f"{kernel_ms:.2f} ms/step over steps 3-{WIDE_TRAIN_STEPS} (first "
          f"{seconds[0] * 1e3:.1f} ms), peak memory allocated "
          f"{kernel_peak / 2**30:.2f} GiB; losses "
          f"{[round(v, 4) for v in losses_.tolist()]}; launches "
          f"{ {k: n for k, n in total.items() if n} }; plain attention 0 on "
          f"{card}", flush=True)
    with SingleWidthGate(), PlainAttentionCount() as plain:
        seconds, _, _, extra = train_run(WIDE_TRAIN, WIDE_TRAIN_STEPS,
                                         amp=False, img_size=WIDE_PX)
    require(plain.calls > 0, "the single-width gate: no plain attention "
            "ran")
    ms = 1e3 * statistics.mean(seconds[2:])
    print(f"phase 12 train {WIDE_TRAIN} fp32 b{TRAIN_B} {WIDE_PX} px, the "
          f"plain attention above 256 tokens (the single-width gate): "
          f"{ms:.2f} "
          f"ms/step, peak memory allocated {extra['peak'] / 2**30:.2f} GiB, "
          f"{plain.calls} plain attention calls ({ms / kernel_ms:.2f}x the "
          f"kernels' time, {extra['peak'] / kernel_peak:.2f}x their memory) "
          f"on {card}", flush=True)
    bound_ = TRAIN_BOUND[torch.float32]
    for label in ("dense", WIDE_TRAIN):
        settle()
        name, kw = MODELS[label]
        model, _ = create_model(name, device=DEVICE, img_size=WIDE_PX,
                                generator=torch.Generator().manual_seed(1),
                                **kw)
        cpu_model = copy.deepcopy(model).cpu()
        kept = record_kept(model)
        cpu_kept = record_kept(cpu_model, follow=kept)
        gen = torch.Generator().manual_seed(2)
        x = torch.randn(WIDE_GRAD_B, 3, WIDE_PX, WIDE_PX, generator=gen)
        y = torch.randint(0, 1000, (WIDE_GRAD_B,), generator=gen)
        opt, _ = create_optimizer(dict(model.named_parameters()),
                                  OptimConfig(lr=1e-3), lambda s: 1e-3, [])
        state = init_train_state(model, opt, device=DEVICE)
        cpu_state = init_train_state(cpu_model, opt, device="cpu")
        model.train()
        cpu_model.train()
        reset_counts()
        with PlainAttentionCount() as plain:
            loss, grads = loss_and_grads(model, label_smoothing_loss,
                                         state.params, x.to(DEVICE),
                                         y.to(DEVICE), StepConfig())
        torch.cuda.synchronize()
        got = launcher_counts()
        require(plain.calls == 0 and got["attention_wide_bwd_tf32"] > 0,
                f"{label} fp32 {WIDE_PX} px B={WIDE_GRAD_B}: launches {got}, "
                f"plain attention {plain.calls}")
        cpu_loss, cpu_grads = loss_and_grads(cpu_model, label_smoothing_loss,
                                             cpu_state.params, x, y,
                                             StepConfig())
        _, loss_rel = rel_err(loss.cpu().reshape(1), cpu_loss.reshape(1))
        require(sorted(kept) == sorted(cpu_kept), f"{label} fp32: reduction "
                f"blocks {sorted(kept)} on the card, {sorted(cpu_kept)} on "
                "the CPU")
        # the CPU's own top-k rows that the card's ids replaced
        ties = sum(int((kept[i] != cpu_kept[i]).any(1).sum()) for i in kept)
        worst_name, worst = max(((n, rel_err(g.cpu(), cpu_grads[n])[1])
                                 for n, g in grads.items()),
                                key=lambda t: t[1])
        require(loss_rel <= bound_["loss"], f"{label} fp32 {WIDE_PX} px: "
                f"loss {loss_rel:.3e} of the CPU's > {bound_['loss']:.0e}")
        require(worst <= bound_["grads"], f"{label} fp32 {WIDE_PX} px: "
                f"gradient {worst_name} {worst:.3e} of max|CPU| > "
                f"{bound_['grads']:.0e}")
        print(f"phase 12 train {label} fp32 B={WIDE_GRAD_B} {WIDE_PX} px "
              f"against the CPU: loss {loss.item():.6f} vs "
              f"{cpu_loss.item():.6f} ({loss_rel:.2e}); worst gradient leaf "
              f"{worst_name} {worst:.2e} of its max|CPU| (bounds "
              f"{bound_['loss']:.0e}, {bound_['grads']:.0e}); the CPU "
              f"gathered the card's kept tokens ({ties} rows of its own "
              f"top-k differed); {got['attention_wide_bwd_tf32']} wide fp32 "
              "backward launches, no plain attention", flush=True)
    return total


def wide_tf32_bwd_record(card: str) -> dict:
    """The fp32 backward's record at B=256, H=6, N=577 (#9's variant, the
    row0 cotangent): against its plain version (1e-4 of its own max), ms
    per launch beside the 3xTF32 bound, the plain version and SDPA's fp32
    backward."""
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    B, (H, N) = TRAIN_B, WIDE_RECORD
    Dh = 64 * H
    qkv = torch.randn(B, N, 3 * Dh, generator=gen, device=DEVICE)
    merged = torch.empty(B, N, Dh, device=DEVICE)
    row0 = torch.empty(B, H, N, device=DEVICE)
    stats = torch.empty(B, H, N, 2, device=DEVICE)
    dout = torch.randn(B, N, Dh, generator=gen, device=DEVICE)
    drow0 = torch.randn(B, H, N, generator=gen, device=DEVICE)
    dqkv = torch.empty_like(qkv)
    _build.short_attention(qkv, merged, H, SCALE, row0=row0, stats=stats,
                           norm_p=True)

    def run():
        _build.short_attention_bwd(qkv, merged, dout, drow0, dqkv, H, SCALE,
                                   stats=stats, row0=row0)

    def plain(sl):
        return [attention_bwd_ref(qkv[sl], dout[sl], drow0[sl], H, SCALE)]

    run()
    torch.cuda.synchronize()
    want = chunked(plain, B)[0]
    abs_err, rel = rel_err(dqkv, want)
    require(rel <= LAUNCH_BOUND[torch.float32], f"attention_wide_bwd_tf32 "
            f"B={B}: {rel:.3e} of max|plain| > {LAUNCH_BOUND[torch.float32]}")
    del want
    q, k, v = packed_heads(qkv, H)
    ms = wide_ms(run)
    lib_ms = wide_ms(sdpa_backward(q, k, v, merged_heads(dout, H)))
    plain_ms = wide_ms(lambda: chunked(plain, B), runs=3)
    flops, nbytes = 10 * B * N * N * Dh, 4 * 7 * B * N * Dh + 4 * B * H * N
    t_ops, t_bytes = flops / (PEAK_TF32_FLOPS / 3), nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"phase 12 attention_wide_bwd_tf32 record fp32 B={B} H={H} N={N} "
          f"backward, row0 cotangent: dqkv {abs_err:.3e} ({rel:.2e}) of max; "
          f"kernel {ms:.4f} ms per launch, bound {bound_ms:.4f} ms "
          f"({bound_by}, 3xTF32), SDPA fp32 backward {lib_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms on {card}", flush=True)
    return dict(shape=f"fp32 B={B} H={H} N={N} backward, row0 cotangent",
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, max_abs_err=abs_err)


def wide_validate(card: str) -> dict:
    """validate --input-size 384 over the synthetic set, fp32 (its default)
    and amp, from a seeded 384-px DeiT-S checkpoint. Returns the
    launches."""
    from tokenreduction_tpu_torch.evaluation import validate
    from tokenreduction_tpu_torch.utils.checkpoint import save_checkpoint

    run = pathlib.Path(__file__).resolve().parent / "build" / "phase12_runs" \
        / "deit_s_384"
    shutil.rmtree(run, ignore_errors=True)
    name, kw = MODELS["dense"]
    model, cfg = create_model(name, device="cpu", img_size=WIDE_PX,
                              generator=torch.Generator().manual_seed(20),
                              **kw)
    save_checkpoint(str(run / "best_checkpoint"), params=model.state_dict(),
                    model_cfg=cfg, run_args={"model": name})
    total = collections.Counter()
    for amp in (False, True):
        reset_counts()
        t0 = time.perf_counter()
        data = validate.main(["--checkpoint", str(run), "--dataset",
                              "synthetic", "--synthetic-n", "128", "-b", "64",
                              "--input-size", str(WIDE_PX)]
                             + (["--use_amp"] if amp else []))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {**counts(), **launcher_counts()}
        total.update(got)
        losses_ = [v["Loss"] for k, v in data.items()
                   if k.startswith("synthetic_")]
        wide_ = got["attention_wide"] if amp else got["attention_wide_tf32"]
        require(len(losses_) == 128 and all(math.isfinite(v) for v in losses_)
                and wide_ == 12 * 2, f"phase 12 validate {WIDE_PX} px "
                f"{'amp' if amp else 'fp32'}: {len(losses_)} images, "
                f"launches {got}")
        print(f"phase 12 validate --input-size {WIDE_PX} "
              f"{'--use_amp' if amp else '(fp32)'}: Acc@1 {data['Top1-Acc']}, "
              f"128 images at b64, {128 / seconds:.1f} img/s end to end; "
              f"launches { {k: n for k, n in got.items() if n} } on {card}",
              flush=True)
    return total


def phase_wide(card: str | None = None) -> tuple[dict, dict]:
    """Phase 12: the attention above 256 tokens. Also callable alone
    (``python3 -c 'import chip_smoke; chip_smoke.phase_wide()'``): it then
    builds the kernels and prints the wide kernels' registers and shared
    memory first. Returns (the wide kernels' records, the launches of the
    384-px path's runs)."""
    t0 = time.perf_counter()
    if card is None:
        require(torch.cuda.is_available(),
                "no CUDA device: chip_smoke.py runs on the GPU only")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(smi, flush=True)
        card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()})"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kern = _build.kernels()
        print(f"phase 12 build: {kern.path} in {kern.build_seconds:.1f} s",
              flush=True)
        for name, line in ptxas_lines(kern.build_log):
            if "wide" in name:
                print(f"phase 12 ptxas: {name}: {line}", flush=True)
        wide_smem_lines("phase 12")
    rec = wide_kernel_checks(card)
    settle()
    rec["attention_wide_bwd_tf32"] = wide_tf32_bwd_record(card)
    settle()
    wide_block_checks(card)
    wide_compositions(card)
    launches = collections.Counter()
    launches.update(wide_eval(card))
    launches.update(wide_fp32(card))
    launches.update(wide_train(card))
    launches.update(wide_train_fp32(card))
    launches.update(wide_validate(card))
    for name in WIDE_LAUNCHERS:
        require(launches[name] > 0, f"phase 12: {name} never launched on "
                "the 384-px path")
    print(f"phase 12 wide done in {time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: launches[k] for k in WIDE_LAUNCHERS} }", flush=True)
    return rec, launches


def elapsed(phase: str):
    print(f"phase {phase} done at {time.perf_counter() - T0:.1f} s",
          flush=True)


def main():
    # phase 0
    root = pathlib.Path(__file__).resolve().parent
    package = pathlib.Path(tokenreduction_tpu_torch.__file__).resolve()
    require(package.parents[1] == root,
            f"the port imported from {package}, not from the checkout {root}")
    require(torch.cuda.is_available(),
            "no CUDA device: chip_smoke.py runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()})"
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0 device: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; TF32 off; SM clock, highest: {clocks}",
          flush=True)

    # phase 1
    kern = _build.kernels()
    print(f"phase 1 build: {kern.path} in {kern.build_seconds:.1f} s "
          f"(0 = already built)", flush=True)
    for name, line in ptxas_lines(kern.build_log):
        print(f"phase 1 ptxas: {name}: {line}")
    cfg = _build.gemm_config()
    smem = cfg["SMEM_BYTES"]
    print(f"phase 1 gemm_sm90_kernel: tile {cfg['BM']}x{cfg['BN']}x"
          f"{cfg['BK']}, {cfg['STAGES']} stages, {smem} bytes of dynamic "
          f"shared memory a block ({smem / 1024:.1f} of the H100's 227 KB; "
          "ptxas counts static shared memory only)", flush=True)
    for n in (197, 138, 97, 68, 50, 13, 4):
        smem = _build.attention_smem(n)
        print(f"phase 1 attention_sm90 N={n}: {smem['forward']} bytes of "
              f"dynamic shared memory a forward block (128 threads), "
              f"{smem['backward']} a backward block (256 threads)",
              flush=True)
    for m, n in RECT_MN:
        print(f"phase 1 attention_sm90 rectangular M={m} N={n}: "
              f"{_build.attention_smem(n, m)['rectangular']} bytes of "
              "dynamic shared memory a block (128 threads)", flush=True)
    tf32 = _build.gemm_tf32_config()
    print(f"phase 1 gemm_tf32_sm90_kernel: tile {tf32['BM']}x{tf32['BN']}x"
          f"{tf32['BK']}, {tf32['STAGES']} stages, {tf32['SMEM_BYTES']} bytes "
          "of dynamic shared memory a block", flush=True)
    bwd = _build.gemm_tf32_bwd_config()
    print(f"phase 1 gemm_tf32_bwd_sm90_kernel: tile {bwd['BM']}x{bwd['BN']}x"
          f"{bwd['BK']}, {bwd['SPLIT_STAGES']} split stages; dY . W "
          f"{bwd['RAW_STAGES_DYW']} raw stages, {bwd['SMEM_BYTES_DYW']} bytes, "
          f"the weight gradient {bwd['RAW_STAGES_WGRAD']} raw stages, "
          f"{bwd['SMEM_BYTES_WGRAD']} bytes of dynamic shared memory a block",
          flush=True)
    cfg = _build.mlp_chunked_config()
    print(f"phase 1 attn_joint_kernel: {_build.attn_joint_smem()} bytes of "
          "dynamic shared memory a block (128 threads, the same at every N); "
          f"mlp_chunked_kernel: {cfg['BM']} rows a block, {cfg['HC']} hidden "
          f"units a slice, {cfg['SMEM_BYTES']} bytes of dynamic shared "
          "memory a block (256 threads)", flush=True)
    for n in sorted({*PROTO_N, *PROTO_BWD_N, 256, 65, 13}, reverse=True):
        print(f"phase 1 proto_attn N={n}: " + ", ".join(
            f"{v} {_build.proto_attn_smem(n, HEADS, v)}"
            for v in proto_attn.VARIANTS) + " bytes of dynamic shared memory "
              f"a block (128 threads); proto_attn_bwd_kernel "
              f"{_build.proto_attn_bwd_smem(n)} (256 threads)", flush=True)
    for n in (*FULL_BLOCK_N, 256):
        plan = _build.attention_tf32_plan(n)
        print(f"phase 1 short_attention_tf32_kernel N={n}: {plan['smem']} "
              f"bytes of dynamic shared memory a block ({plan['threads']} "
              f"threads), {plan['chunks']} chunks of 32 keys in registers; "
              f"short_attention_bwd_tf32_kernel: {plan['bwd_smem']} bytes",
              flush=True)
    for m, n in (*RECT_MN, RECT_WIDE_MN, (256, 256)):
        print(f"phase 1 short_attention_tf32_kernel rectangular M={m} N={n}: "
              f"{_build.attention_tf32_plan(n, m)['rect_smem']} bytes of "
              "dynamic shared memory a block", flush=True)
    for fn, line in tf32_sass(kern.path).items():
        print(f"phase 1 sass: {fn}: {line}", flush=True)
    wide_smem_lines("phase 1")
    for K in (D, 192):
        warps = _build.LN_BWD_WARPS if K == D else 8
        print(f"phase 1 layer_norm_bwd K={K}: {warps * 2 * K * 4} bytes of "
              f"dynamic shared memory a block ({warps * 32} threads)",
              flush=True)
    elapsed("1")

    rec = phase_kernels()
    phase_launchers()
    gemm_rec = phase_gemms()
    attn_rec = phase_attention()
    fp32_rec = phase_fp32()
    ln_bwd_rec = phase_ln_bwd()
    keys_rec = phase_keys()
    sums_rec = phase_sums()
    ln_rec = layer_norm_record()
    standalone = phase_standalone()
    elapsed("2")
    for dtype in (torch.float32, torch.bfloat16):
        phase_models(dtype)
    for dtype in (torch.float32, torch.bfloat16):
        phase_train_models(dtype)
    sinkhorn_step_check()
    dropout_step_check()
    phase_distill()
    elapsed("3")
    launches = phase_serve(card)
    # the fp32 rectangular attention's path: ATS@0.7's fp32 forwards
    launches["rect_attention_tf32"] = \
        phase_fp32_eval(card)["rect_attention_tf32"]
    elapsed("4")
    trained = phase_train(card)
    for name in (*WRAPPERS, *LAUNCHERS):
        launches[name] += trained[name]
    elapsed("5")
    evaluated = phase_eval(card)
    for name in (*WRAPPERS, *LAUNCHERS):
        launches[name] += evaluated[name]
    elapsed("6")
    trained_cli = phase_cli(card)
    for name in (*WRAPPERS, *LAUNCHERS):
        launches[name] += trained_cli[name]
    elapsed("7")
    trained_flags = phase_flags(card)
    for name in (*WRAPPERS, *LAUNCHERS):
        launches[name] += trained_flags[name]
    elapsed("8")
    tools_rec = phase_tools()
    elapsed("9")
    proto_rec = phase_proto()
    elapsed("10")
    trained_parallel = phase_parallel(card)
    for name in (*WRAPPERS, *LAUNCHERS):
        launches[name] += trained_parallel[name]
    elapsed("11")
    wide_rec, wide_path = phase_wide(card)
    for name in (*WRAPPERS, *LAUNCHERS):
        launches[name] += wide_path[name]
    elapsed("12")
    for name, shape, ms, bound_ms, lib_ms in standalone:
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"standalone {name} {shape}: {ms:.4f} ms per launch, bound "
              f"{bound_ms:.4f} ms (bytes), library {lib}; {launches[name]} "
              "launches on the main path (phases 4-6)", flush=True)

    kernels = [dict(name=name, route="cuda", source=CUDA_SOURCES[name][0],
                    cuda_sources=CUDA_SOURCES[name],
                    wrapper=WRAPPER_SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    on_main_path=name not in OFF_PATH_WRAPPERS,
                    library_ms=None, **rec[name]) for name in WRAPPERS]
    kernels += [dict(name=name, route="cuda", source=GEMM_SOURCE,
                     wrapper="tokenreduction_tpu_torch/ops/_build.py",
                     replaces=GEMM_REPLACES[name], launches=launches[name],
                     on_main_path=True, **gemm_rec[name]) for name in GEMMS]
    kernels += [dict(name=name, route="cuda", source=ATTENTION_SM90,
                     wrapper="tokenreduction_tpu_torch/ops/_build.py",
                     replaces=ATTENTION_REPLACES[name],
                     launches=launches[name], on_main_path=True,
                     **attn_rec[name])
                for name in (*ATTENTIONS, "rect_attention")]
    # the fp32 kernels on the tensor cores: their launches are the DyViT
    # teacher's fp32 #1 (phase 5)
    kernels += [dict(name=name, route="cuda", source=source,
                     wrapper="tokenreduction_tpu_torch/ops/_build.py",
                     replaces=REPLACES["fused_full_block"],
                     launches=launches[name], on_main_path=True,
                     **fp32_rec[name])
                for name, source in (("gemm_tf32", GEMM_TF32_SOURCE),
                                     ("attention_tf32", ATTENTION))]
    # the fp32 backward's kernels and the fp32 rectangular attention: their
    # launches are phase 5's fp32 train step's and phase 4's ATS@0.7 fp32
    # forwards'
    for name in ("attention_bwd_tf32", "rect_attention_tf32",
                 "gemm_bwd_tf32", "gemm_wgrad_tf32"):
        require(launches[name] > 0, f"{name}: no launch on its path")
    kernels += [dict(name=name, route="cuda", source=source,
                     wrapper="tokenreduction_tpu_torch/ops/_build.py",
                     replaces=ATTENTION_REPLACES[replaces],
                     launches=launches[name], on_main_path=True,
                     **fp32_rec[name])
                for name, source, replaces in (
                    ("attention_bwd_tf32", ATTENTION_BWD,
                     "short_attention_bwd"),
                    ("rect_attention_tf32", ATTENTION, "rect_attention"))]
    kernels += [dict(name=name, route="cuda", source=GEMM_TF32_BWD_SOURCE,
                     wrapper="tokenreduction_tpu_torch/ops/_build.py",
                     replaces=GEMM_REPLACES["gemm_wgrad"],
                     launches=launches[name], on_main_path=True,
                     **fp32_rec[name])
                for name in ("gemm_bwd_tf32", "gemm_wgrad_tf32")]
    kernels += [dict(name=name, route="cuda", source=source,
                     wrapper="tokenreduction_tpu_torch/ops/_build.py",
                     replaces=replaces, launches=launches[name],
                     on_main_path=True, **record)
                for name, source, replaces, record in (
                    ("layer_norm_bwd", LN_GEMM, LN_BWD_REPLACES, ln_bwd_rec),
                    ("layer_norm", LN_GEMM, LN_REPLACES, ln_rec),
                    ("sum_partials", LN_GEMM, SUMS_REPLACES, sums_rec),
                    ("head_mean_keys", ATTENTION, KEYS_REPLACES, keys_rec))]
    # the wide kernels above 256 tokens (phase 12): their launches are the
    # 384-px path's
    kernels += [dict(name=name, route="cuda", source=WIDE_SOURCES[name][0],
                     wrapper="tokenreduction_tpu_torch/ops/_build.py",
                     replaces=WIDE_SOURCES[name][1], launches=launches[name],
                     on_main_path=True, **wide_rec[name])
                for name in WIDE_LAUNCHERS]
    # the kernel tools' four (phase 9): on no path of the models
    kernels += [dict(name=name, route="cuda", source=sources[0],
                     cuda_sources=sources, wrapper=wrapper, replaces=replaces,
                     on_main_path=False, library_ms=None, **tools_rec[name])
                for name, (_, sources, wrapper, replaces)
                in TOOL_KERNELS.items()]
    # the attention-core prototypes' two (phase 10): on no path either
    kernels += [dict(name=name, route="cuda", source=sources[0],
                     cuda_sources=sources, wrapper=wrapper, replaces=replaces,
                     on_main_path=False, library_ms=None, **proto_rec[name])
                for name, (_, sources, wrapper, replaces)
                in PROTO_KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--phase11"]:
        par_child(*sys.argv[2:5])
    else:
        main()
