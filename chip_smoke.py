"""Smoke run of the torch port (epn_pointcloud_tpu_torch) on one CUDA card.

  python3 chip_smoke.py [--parent-csrc DIR]

--parent-csrc: DIR is the csrc/ directory of an earlier tree (for example
from ``git archive <commit> epn_pointcloud_tpu_torch/csrc | tar -x -C D``);
its fps.cu, ball_query.cu, inter_conv.cu, inter_conv_bwd.cu and
intra_conv.cu are each built alone beside the kernels; its epn_fps and
epn_ball_query are timed by the device timer beside this tree's fps and
ball query (and held to the same indices, printed as ``parent_equal``) at
every call of phases 2, 12 and 16, and its epn_inter_conv_mma, epn_inter_conv_f,
epn_intra_conv, epn_intra_conv_prenorm_df, epn_inter_conv_bwd_table,
epn_inter_conv_dg, epn_inter_conv_bwd_w and epn_intra_conv_bwd_w (bf16)
are timed beside this tree's bf16 W-fused inter forward, W-off F, prenorm
intra forward, B6 df, fused dTable, W-off dG, fused dW and B6 dW at every
call of phases 4, 9 and 16, and its epn_inter_conv_bwd_w,
epn_inter_conv_bwd_table, epn_inter_conv_dg, epn_inter_conv_f and
epn_intra_conv_bwd_w (fp32) beside this tree's fp32 fused dW, fused
dTable, W-off dG, W-off F and intra dW at every call of phases 6 and 12,
on the same inputs, in turns (parent, new, new, parent), and its
epn_intra_conv (fp32) beside this tree's fp32 intra forward and df at every
call of phases 2, 6 and 12, and its epn_inter_conv (fp32, the SGEMM
template) beside this tree's fp32 W-fused inter forward at every call of
phases 2, 6 and 12; its epn_inter_conv (fp32), epn_inter_conv_bwd_w_f32 and
epn_inter_conv_f_f32 are also timed beside this tree's same kernels, whose
F build now runs the shared add_neighbor step, and held to the same bits;
its epn_ones_conv is timed by the device timer beside this tree's ones
conv at every call of phases 2, 4, 6, 9, 12, 14, 16 and 18, in turns (its
bits printed as ``parent_equal``, not gated).

Phases (any failure exits non-zero and prints no result line):
  1. build the CUDA kernels from csrc/ (one nvcc a source, in parallel,
     sm_90a), and count the tensor-core instructions (HMMA, GMMA) in the
     SASS of the bf16 tensor-core kernels (the grouped conv forward and
     backward, the W-fused inter forward, the W-off F, the intra forward
     and B6 df, the inter backward scatter, the fused inter dW, the intra
     dW; cuobjdump): none fails; and in the SASS of the fp32 CUDA-core
     kernels of the W-fused inter forward (inter_fwd_f32_kernel), the
     fused inter dW (inter_dw_f32_kernel), the backward
     scatter (inter_bwd_f32_kernel), the W-off F (inter_f_f32_kernel),
     the intra dW (intra_dw_f32_kernel), the intra forward and df
     (intra_fwd_f32_kernel) and the ones conv (ones_conv_kernel) FFMA and
     no HMMA or GMMA (no TF32);
  2. at every flagship layer shape of cls_so3net_pn (b=32, 1024 points, 60
     anchors), compare each kernel with its plain PyTorch version on the
     card, on the inputs the model itself gives it (captured from a b=32
     forward of a seeded full-width model on a synthetic cloud batch), and
     time both (median of CUDA-event timings after warmup); every intra
     forward on its fp32 CUDA-core kernel ('fwd_f32'), bitwise equal on a
     second call, its error against a float64 forward at most 1.5 times
     the SGEMM's (this tree's epn_intra_conv on the same inputs), timed
     beside one torch.mm of the gathered f by W (and, --parent-csrc,
     beside the earlier tree's fp32 SGEMM under one timer); every inter
     forward on its fp32 CUDA-core kernel ('fwd_f32'), bitwise equal on a
     second call, its error against a float64 forward at most 1.5 times
     the template's (this tree's epn_inter_conv, bf16 = 0), timed beside
     its composition (the W-off F kernel, then one torch.mm(F, W); no one
     PyTorch call computes it) with the device memory each needs (and,
     --parent-csrc, beside the earlier tree's template under one timer);
  3. run the full forward at b=8 on the kernel path and on the plain path;
     the logits must agree to rtol=1e-3, atol=2e-3; then time the whole
     b=32 forward on both paths, in turns;
  4. the bf16 production mode (--compute-dtype bf16) of the same model:
     each kernel call of a b=32 bf16 forward (ones conv, bf16 inter conv,
     prenorm intra conv, moments, fused tail, grouped conv) against its
     plain version on the same inputs (normwise <= 4e-3 for bf16 outputs,
     <= 1e-5 for the moments' fp32 sums), timed, with torch.addmm beside
     the grouped conv and torch.var_mean beside the moments; every inter
     conv call on the tensor-core kernel,
     bitwise equal on a second call, within 1e-3 of the plain version at
     its rounding points (inter_conv_mma_plain: the anchor weights and F
     rounded to bf16, as the TPU kernel rounds them), and timed beside the
     composition it fuses (the W-off F kernel of the bf16 route, then one
     torch.mm(F, W));
     every prenorm intra call on the tensor-core kernel, bitwise equal on
     a second call, timed beside one torch.mm of its gathered operand
     [M, 12C] by W [12C, D] (the operand formed beforehand) and beside
     the whole composition (fold, gather, torch.mm);
     the b=8 bf16 logits on the kernel and plain paths to a per-sample
     cosine >= 0.9999, the b=32 bf16 and fp32 kernel paths to a minimum
     cosine >= 0.999, and the whole b=32 bf16 forward timed on both paths,
     in turns;
  5. write a synthetic ModelNet40 test tree (1024-point clouds, 2 batches of
     32) and run the eval entry point (run_modelnet --run-mode eval -b 32) on
     it, in fp32 and then with --compute-dtype bf16; the logits must be
     finite, every kernel's launch count must rise by its expected count
     per batch, and every inter forward, intra forward and B6 df must have
     run the kernel of its dtype (the tensor-core kernels in bf16, in fp32
     the CUDA-core inter and intra forwards, 'fwd_f32', the inter
     template's and the intra SGEMM's 'sgemm' nowhere; so in phases 8, 11,
     15, 19, there
     with every fused
     dTable, W-off dG, fused dW and W-off F too: the tensor-core scatter,
     dW and F in bf16; in fp32 the CUDA-core kernels of the fused dW
     (inter_dw_f32_kernel, 'dw_f32') and of the fused dTable and W-off dG
     (inter_bwd_f32_kernel, 'dtable_f32', 'dg_f32'), of the W-off F
     (inter_f_f32_kernel, 'f_f32') and of the intra dW
     (intra_dw_f32_kernel, 'dw_f32'; the SGEMM's 'dw' nowhere));
  6. capture each backward kernel call of one train-mode step of the seeded
     full-width model on a synthetic b=12 batch (inter dTable and dW at 6
     layers, intra df and dW at 7), and the step's 6 W-fused inter
     forwards (checked and timed as in phase 2), and compare each with its
     plain version
     on the same inputs (normwise relative error <= 1e-5 for dTable and df,
     <= 1e-4 for the dW reductions), timing both; every inter dW on the
     fp32 CUDA-core kernel ('dw_f32'), bitwise equal on a second call, its
     error against a float64 dW (inter_conv_dw_plain in float64) at most
     twice the template's (this tree's epn_inter_conv_bwd_w on the same
     inputs), timed beside one torch.mm(F^T, dout) (and, --parent-csrc,
     beside the earlier tree's fp32 template under one timer); every
     dTable on the fp32 CUDA-core scatter ('dtable_f32'), timed beside one
     torch.mm(dout2, W2^T) and that torch.mm then the CUDA-core dG (and,
     --parent-csrc, beside the earlier tree's fp32 template); every intra
     dW on its fp32 CUDA-core kernel ('dw_f32'), bitwise equal on a
     second call, its error against a float64 dW at most 1.5 times the
     SGEMM's (this tree's epn_intra_conv_bwd_w on the same inputs), timed
     beside one torch.mm of the gathered f by dout (and, --parent-csrc,
     beside the earlier tree's fp32 SGEMM under one timer); every intra
     df on the fp32 CUDA-core forward kernel ('fwd_f32'), checked and
     timed as the forward in phase 2 (its yardstick: one torch.mm of the
     dout gathered through the inverse adjacency by W^T);
  7. one train step (b=12) on the kernel path and on the plain path
     (``kernels.plain()``: plain forward, torch autograd) from the same
     weights: loss to rtol 1e-5, per-leaf gradients by the rule of
     tests/test_reference_train_parity.py, BatchNorm running statistics to
     rtol 1e-4; then the whole step (forward, backward, Adam) timed on both
     paths in turns, and 10 Adam steps on one batch must lower the loss;
  8. write a synthetic tree with train and testR splits and run the train
     entry point (run_modelnet --run-mode train -i 4 --save-freq 4): finite
     logged losses, each kernel's launch count risen by its per-step count
     (plus the eval at iteration 4), and the saved checkpoint evaluated
     through --run-mode eval -r;
  9. [bf16-backward] capture each backward kernel call of one bf16 train
     step (b=12) of the seeded full-width model: bf16 dTable and inter dW at
     6 layers, the prenorm intra df (with dscale, dshift) and dW at 7, the
     grouped 1x1 conv backward (dx, dW and dbias in one launch) at 7 (6
     skips and the head); compare each with its plain version on the same
     inputs (normwise relative error <= 8e-3 for bf16 outputs, <= 1e-3 for
     fp32 ones), timing both, with the two torch.mm (dx, dW) beside the
     grouped conv's backward, and its outputs bitwise equal on a second
     call; every prenorm intra df on the tensor-core kernel, bitwise equal
     on a second call, beside its torch.mm and composition as in phase 4;
     every dTable on the tensor-core scatter, its fp32 dT within 1e-3 of
     the plain version at the TPU kernel's rounding points (dF, the anchor
     weights and each slot's sum in bf16), timed beside one
     torch.mm(dout2, W2^T) (the dF product it fuses) and the composition it
     replaces (that torch.mm, then the tensor-core dG); every inter dW on
     the tensor-core kernel, its fp32 dW within 1e-3 of the plain version
     at the TPU kernel's rounding points (the anchor weights and F in
     bf16) and bitwise equal on a second call, timed beside one
     torch.mm(F^T, dout); every B6 dW on its tensor-core kernel
     (intra_dw_mma_kernel), within 1e-3 of the plain version and bitwise
     equal on a second call, timed beside one torch.mm of the gathered z
     by dout; the fp32 step's intra df (phase 6) beside one torch.mm of
     its product (the gathered dout by W^T);
 10. [bf16-train] one bf16 train step (b=12) on the kernel path and on the
     plain path from the same weights: loss to rtol 1e-3, every parameter
     with a gradient on both paths, per-leaf gradient cosine >= 0.9 and its
     median no lower than the lowest of three medians of the kernel path
     against itself on clouds scaled by 1 + 1e-6, 1 - 1e-6 and 1 + 2e-6,
     less 0.02 (bf16 gradients are that sensitive to rounding;
     the leaves whose float64 gradient is ~0 are bf16 noise: the kernel
     path's at most 4 times the plain path's plus 1e-2), running statistics;
     every B6 dW call of the kernel path's step within 1e-3 (normwise) of
     intra_conv_prenorm_dw_plain on its own inputs, and all of them on the
     tensor-core dW (the 'dw_mma' count printed);
     the whole step timed on both paths (median of 5), and the bf16 step's
     loss and per-leaf gradient cosine against the fp32 step on the same
     weights and batch printed (not gated);
 11. [bf16-train-entry] run_modelnet --run-mode train --compute-dtype bf16
     -i 4 --save-freq 4 on the synthetic tree, each kernel's launch count
     risen by its bf16 per-step count (plus the bf16 eval at iteration 4),
     then the checkpoint through --run-mode eval --compute-dtype bf16 -r;
 12. [inv-kernels] the 3DMatch descriptor model inv_so3net_pn at full width
     (fp32): each kernel call of one triplet step (two legs of b=16
     1024-point patches from the port's FragmentLoader on a dense synthetic
     3DMatch tree) against its plain version on the same inputs, timed
     (beside one PyTorch call where one computes the same function: the
     torch.mm yardsticks of phase 9, and for the W-off inter_conv_f one
     batched torch.matmul of the anchor weights by the gathered table
     rows; fps and ball_query indices equal; normwise <= 1e-5 for the forward
     kernels, df, dTable and the W-off inter_conv_f / inter_conv_dg, <=
     1e-4 for the dW reductions; every fused dW, dTable, intra forward,
     intra df and intra dW on its fp32 CUDA-core kernel, checked and timed
     as in phases 2 and 6, every
     W-off dG on
     the CUDA-core scatter ('dg_f32', beside the earlier tree's template
     with --parent-csrc); every W-off F on its CUDA-core kernel ('f_f32'),
     bitwise equal to this tree's template on the same inputs and on a
     second call, beside the earlier tree's template with --parent-csrc);
     every inter forward on its CUDA-core kernel, checked and timed as in
     phase 2;
     then the composed backward route (its four parts) timed beside the
     fused dTable + dW at B1L0, B2L0, B3L0;
 13. [inv-train] one inv triplet step on the kernel path and on the plain
     path from the same weights: loss to rtol 1e-5, a gradient for every
     parameter on both, the per-leaf rule (degenerate leaves from a float64
     step), the kernel path's launches by kernel as in phase 15; on three
     batches, B0L1's inter W gradient on both paths against a float64
     step (printed); the whole step timed on both paths in turns; 10 Adam
     steps lower the loss;
 14. [inv-descriptor] the eval-mode inv forward at b=48 on both paths:
     descriptors to rtol 1e-3, atol 2e-3, timed; every inter forward of the
     kernel path on its CUDA-core kernel, within 1e-5 of its plain version,
     bitwise equal on a second call, at most 1.5 times the template's
     float64 error;
 15. [inv-train-entry] run_3dmatch --run-mode train -i 4 --save-freq 4 on
     the synthetic tree, each kernel's launch count risen by its per-step
     count, params.json written, then the checkpoint reloaded through -r;
 16. [inv-bf16-kernels] each kernel call of one bf16 inv triplet step (the
     same legs) against its plain version on the same inputs, timed: fps
     and ball_query indices equal, normwise <= 8e-3 for bf16 outputs and
     <= 1e-3 for fp32 ones, the inter forward also as in phase 4 (the
     tensor-core kernel, bitwise, <= 1e-3 of inter_conv_mma_plain, beside
     its composition), the prenorm intra conv and B6 df as in phases 4 and
     9 (the bf16 inter_conv_f / inter_conv_dg, the
     prenorm intra conv with a fold a patch and its backward, moments
     (beside torch.var_mean), the
     grouped conv and its backward, the fused inter backward, every
     dTable and dG on the tensor-core scatter and every dW on the
     tensor-core kernel as in phase 9, every B6 dW on its tensor-core
     kernel as in phase 9; torch.addmm
     and torch.mm beside the grouped conv's); every inter_conv_f on the
     tensor-core F (inter_f_mma_kernel), within 1e-3 (normwise) of
     inter_conv_f_plain and bitwise equal on a second call, timed beside
     one batched torch.matmul of the anchor weights by the gathered rows;
     the
     composed route's dW product against its float64 product (<= 1e-3);
 17. [inv-bf16-train] one bf16 inv step on the kernel and the plain path
     from the same weights by the rule of [bf16-train] (loss to rtol 1e-3,
     every parameter with a gradient, per-leaf cosine >= 0.9, the median
     no lower than the kernel path's noise floor of three draws less
     0.02; every B6 dW call within 1e-3 of its plain version, all on
     the tensor-core dW), peak memory,
     the step timed on both paths; bf16 vs fp32 printed;
 18. [inv-bf16-descriptor] bf16 descriptors at b=48, kernel vs plain path:
     per-patch cosine >= 0.999 (or the kernel path's noise floor less
     0.01, when that floor lies lower), timed;
 19. [inv-bf16-train-entry] the main path: run_3dmatch --run-mode train
     --compute-dtype bf16 -i 4 --save-freq 4, launch counts, params.json,
     the checkpoint reloaded through -r --compute-dtype bf16.
 20. [reg-kernels] the rotation model reg_so3net at full width (fp32,
     b=8 alignment pairs from the port's alignment loader on synthetic
     asymmetric airplanes: one forward of 16 clouds): each kernel call of
     one train step against its plain version, timed, with phase 12's
     checks; its launches by kernel printed, every one on its CUDA-core
     kernel;
 21. [reg-forward] the eval pair forward at b=8 on the kernel and the
     plain path: confidence and y to rtol 1e-3, atol 2e-3, timed (median
     of 5) as pairs a second;
 22. [reg-train] one reg step on both paths: loss to rtol 1e-5, every
     parameter with a gradient, the per-leaf rule (degenerate leaves from a
     float64 step, two pairs at a time), timed; 10 Adam steps lower the
     loss;
 23. [reg-bf16] the bf16 forward (per-pair cosine of confidence and y >=
     0.999, or the noise floor less 0.01) and step (the rule of
     [inv-bf16-train]) of the reg model, with peak memory, timed;
 24. [reg-entry] run_modelnet_rotation --run-mode train -i 4 --save-freq
     4 in fp32 and in bf16 (a main path of this slice), launch counts by
     kernel, params.json; then --run-mode eval -r: the same weights, its
     launches, a finite median angular error (working directory under
     build/);
 25. [3dmatch-eval-entry] run_3dmatch --run-mode eval -r on phase 15's
     checkpoint (fp32) and phase 19's (--compute-dtype bf16) over a
     synthetic scene of 3 fragments of 384 keypoints, 192 patches a
     forward (the JAX package's eval chunk): features, recall.txt and
     recall.csv written, launch counts; every kernel call of one chunk of
     192 against its plain version, the chunk's descriptors kernel vs
     plain path (fp32 rtol 1e-3, atol 2e-3; bf16 per-patch cosine >=
     0.999); the host seconds beside the forward's and the device's.
 26. [ref-convention] cls_so3net_pn (60 anchors, 1024 points) under the
     reference anchor convention (``set_convention('reference')``: the
     original EPN's anchors, kernel points, adjacency and ball-query
     fill), its weights an original-EPN-layout state_dict made from a
     seed and loaded by ``compat.load_reference_state_dict``: each kernel
     call of a b=32 forward in fp32 and in bf16 against its plain version
     (``check_calls``: the bounds of phases 2 and 7 and every kernel's
     extras and route gates; every ball query with the reference fill,
     and the count of its queries with exactly n_sample - 1 hits
     printed), the b=8 and b=32 logits kernel vs plain path (b=32 bf16:
     the plain path at the kernel's rounding points), the b=32 forwards
     timed; then the ball
     query's reference fill index-equal to plain on both kernels ('warp'
     at 16 slots, 'thread' at 300) on clouds with planted queries of
     exactly n_sample - 1 hits (their count printed);
 27-29. [ka20], [ka40], [kpconv] cls_so3net_pn at kanchor 20, 40 and one
     anchor (``-k``), 1024 points, full width, seeded: each kernel call of
     a b=32 forward in fp32 and in bf16 and of a b=12 fp32 train step
     against its plain version (``check_calls``, as phase 26, the
     templates' routes let through), the inter routes (the templates in
     fp32 and at one anchor, the tensor-core forward in bf16 at 20 and 40)
     printed and held; the b=8 logits kernel vs plain path, the b=32 bf16
     kernel path vs the plain path at its rounding points (cosine >= 0.999
     or that reference's own to fp32), the b=32 bf16 vs fp32 kernel paths
     (cosine >= 0.99; the plain paths' and the noise floor printed beside
     it), the b=32 forwards timed; the train step kernel vs plain path
     (loss to rtol 1e-5 with the rotation CE relabelled into the subset;
     the per-leaf rule of phase 7), timed;
 30. [ka20-entry] this slice's main path: run_modelnet --kanchor 20
     --run-mode train -i 2, then --run-mode eval -r -b 32 on its
     checkpoint; each kernel's launches counted from 0 before each run and
     held to the per-step and per-batch counts, the inter routes held.
 31-36. [inv-ka20], [inv-ka40], [inv-kpconv], [reg-ka20], [reg-ka40],
     [reg-kpconv] inv_so3net_pn (b=48 descriptors, the triplet step of two
     legs of 16 patches) and reg_so3net (b=8 pairs: the pair forward and
     its step) at kanchor 20, 40 and one anchor, full width, seeded, in
     fp32 and bf16: each kernel call against its plain version
     (``check_calls``), the inter routes held to the templates (the W-off
     F and dG to 'f' / 'dg'); the forward kernel vs plain path (bf16: the
     plain path at the kernel's rounding points), the step's loss (fp32
     with the per-leaf rule), both timed;
 37. [ka20-bf16-train] the cls b=12 bf16 step at kanchor 20: each call
     against its plain version, the step by the noise-floor rule;
 38. [dropout] cls at 60 anchors with --dropout-rate 0.5: a b=12 bf16 step
     on the plain intra route (no prenorm launch; its dW on the tensor-core
     intra dW) against the plain path on the same masks, and a b=32 bf16
     eval with no fused tail against the dropout-free model's logits;
 39. [option-entries] this slice's main paths: run_3dmatch --kanchor 20
     train -i 2 then --run-mode eval -r, run_modelnet_rotation --kanchor
     20 train -i 2 then eval -r, run_modelnet --dropout-rate 0.5
     --debug-mode knownatt -u attention --compute-dtype bf16 -i 2; each
     run's launches counted from 0 and held.
 40. [pooling] cls with xyz_pooling 'stride' and 'no-stride' (every inter
     conv on the unfused path: the blur, the grouping, the W-off F on its
     CUDA-core / tensor-core kernel, the product by torch.mm): b=32
     forwards in both dtypes, their launches counted from 0 and held,
     their calls against their plain versions (both dtypes of 'stride',
     fp32 of 'no-stride'), the logits against the plain path; a b=12 fp32
     step of the 'stride' model, kernel vs plain path by the per-leaf rule,
     its calls held; all timed;
 41. [relu] cls with every activation 'relu': a b=32 bf16 eval (the
     prenorm intra conv and the fused tail called with the slope 0, each
     call held to its plain version at that slope), a b=12 fp32 step by
     the per-leaf rule, a b=12 bf16 step (B5, B6 df and dW at slope 0,
     each call held; the step by the noise-floor rule), timed; then the
     leaky model's logits against the plain path;
 42. [heads-propagation] ClsOutBlockR (its intra conv on the one-point
     field held to its plain version), InvOutBlockR and
     InvOutBlockPointnet on the cls backbone's b=32 field, a
     PropagationBlock over a 16384-point fragment (the fps kernel's
     centers) and the separable block at one anchor, each kernel vs plain
     path, launches counted, timed.
 43. [dp-nccl-1] data parallelism in a NCCL world of one rank in this
     process: the cls b=12 step in fp32 and bf16 and the inv step (b=16 a
     leg, fp32) through the trainers' distributed path
     (``parallel.dryrun``: the weights broadcast, the gradients all-reduced
     in one flattened call) against the same step of a trainer with no
     group (``dryrun.check_group_of_one``): bitwise the weights, loss,
     running statistics, all-reduced gradients and parameters after Adam;
     the gradients as close to the step alone's as a repeat of it
     (``dryrun.REPEAT_ERR``: the fused dTable's atomics change their last
     bits from run to run); each step's median time with
     and without the group (CUDA events, in turns); the group destroyed;
 44. [dp-gloo-2] two ranks on this card over gloo (two processes started
     by ``parallel.dryrun.launch``, both on cuda:0; NCCL refuses two ranks
     on one card), full width: cls b=12 (6 a rank) in fp32 and bf16, inv
     b=16 a leg (8 a rank) and reg b=8 pairs (4 a rank) in fp32, each
     against this process's step on the whole global batch
     (``dryrun.compare``: fp32 loss to rtol 1e-5 and every leaf at the
     fixed cosine and max-error gates of its kind, ``dryrun.FP32_GATES``,
     set between the card's readings of the reduction
     order alone and of statistics taken over a rank's half
     (``epn_pointcloud_tpu_torch.dp_variants``); the cls and inv steps on
     each half taken apart must fail them; bf16 by the [bf16-train] rule;
     BatchNorm running statistics), both ranks' results bitwise equal,
     every kernel route of one process launched on each rank; a rank that
     fails or outlives 300 s fails the phase.
     Correctness only: two processes on one card say nothing of speed;
 45. [dp-nccl-2] phase 44 under NCCL, one card a rank, where the machine
     has two cards; with one it prints that it did not run and why.

Every phase prints its wall time (``[phase] phase wall S s``), and the
script's total its last ``[done]`` line.

Every ones conv call (block 0 layer 0: phases 2 and 4 at b=32, the b=12
steps of phases 6 and 9, the inv steps of phases 12 and 16 and the b=48
descriptors of phases 14 and 18) is held to ones_conv_plain on its inputs
(fp32 normwise <= 1e-5, bf16 <= 4e-3), bitwise equal on a second call,
and in fp32 its error against a float64 evaluation at most 1.5 times the
plain fp32 version's (``rel_f64``, ``plain_rel_f64``, ``f64_ratio``).

The short kernels (fps, ball_query, the ones conv, moments) are timed
twice in phases 2, 4, 12 and 16: ``kernel_ms`` by CUDA events around up to
20 back-to-back wrapper calls (``time_ms``, which for a call of a few
microseconds times the wrapper's host work), and ``device_ms`` by CUDA
events around the replay of those calls captured into a CUDA graph
(``device_ms``; moments' torch.var_mean as ``library_ms_device``); a call
that cannot be captured fails its phase. Every fps call must run the
register kernel ('reg' in the wrapper's ``fps.routes``) and every ball
query the warp kernel ('warp' in ``ball_query.routes``), in the compared
calls and in the entry runs' launches by kernel.

Prints one line per comparison, a JSON line with per-kernel results (each
with its bound: the larger of its bytes over 3.35 TB/s and its operations
over the peak for their type, 67 TFLOP/s fp32 or 989 TFLOP/s bf16, from the
shapes of the calls timed), the card's name and power limit, and as its
last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Details go to chiprun_out/chip_smoke_results.json and the nvcc/ptxas log to
chiprun_out/kernels_build.log.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, 'chiprun_out')
WORK_DIR = os.path.join(ROOT, 'build', 'chip_smoke')
BATCH = 32
TRAIN_BATCH = 12
N_POINTS = 1024
SEED = 2913
# the H100 SXM's published peaks (NVIDIA data sheet, dense): fp32 on the
# CUDA cores, bf16 on the tensor cores, and device memory
PEAK_FP32, PEAK_BF16, HBM_BYTES_S = 67e12, 989e12, 3.35e12


def log(msg):
    print(msg, flush=True)


# each phase's wall seconds, by its tag
PHASE_WALL = {}


def timed(tag, fn, *args, **kwargs):
    """fn(*args, **kwargs), its wall time logged and kept in PHASE_WALL."""
    t0 = time.time()
    out = fn(*args, **kwargs)
    PHASE_WALL[tag] = time.time() - t0
    log(f'{tag} phase wall {PHASE_WALL[tag]:.1f} s')
    return out


def _nbytes(ts):
    import torch
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def work(name, args, out):
    """(bytes, fp32 operations, bf16 operations) one call of kernel ``name``
    needs at these shapes: each input read once and each output written
    once; the algorithm's operations, the products of a bf16 kernel counted
    as bf16 tensor-core work and everything else as fp32."""
    import torch
    outs = out if isinstance(out, tuple) else (out,)
    nb = _nbytes(list(args) + list(outs))
    f32 = mm = 0
    bf16 = False
    if name == 'fps':
        b, n, _ = args[0].shape
        f32 = 10 * b * args[1] * n           # a distance, min and argmax a point
    elif name == 'ball_query':
        q, sup = args[0], args[1]
        f32 = 9 * q.shape[0] * q.shape[1] * sup.shape[1]
    elif name == 'ones_conv':
        # a weight (c - h) + gx . a by three fused multiply-adds (6), its
        # relu (1) and its sum (1); the expansion written out, (|gx|^2 +
        # |kappa|^2) - 2 gx . R_a kappa_k then 1 - d2 / sigma, is 10
        b, p2, nn, _ = args[0].shape
        na, K = args[1].shape[:2]
        f32 = 8 * b * p2 * nn * na * K
    elif name in ('inter_conv_f', 'inter_conv_dg'):
        # F without W: the anchor weights and the neighbor contraction (dG:
        # its transpose, folded onto the table rows), the contraction on
        # the bf16 peak when its operand (the table, dF) is bf16
        idx, rk = args[1], args[3]
        b, p2, nn = idx.shape
        na, K = rk.shape[:2]
        t = args[2 if name == 'inter_conv_f' else 5]
        c, bf16 = t.shape[-1], t.dtype == torch.bfloat16
        M = b * p2 * na
        f32 = 9 * M * nn * K
        mm = 2 * M * nn * K * c
    elif name.startswith('inter_conv'):
        gx, idx, rk = args[0], args[1], args[3]
        b, p2, nn = idx.shape
        na, K = rk.shape[:2]
        if name == 'inter_conv':
            c, d = args[2].shape[3], args[5].shape[2]
        elif name == 'inter_conv_dtable':
            c, d = args[5].shape[1], args[5].shape[2]
        else:
            c, d = args[2].shape[3], args[5].shape[-1]
        bf16 = args[6 if name == 'inter_conv_dtable' else 2].dtype == \
            torch.bfloat16
        M = b * p2 * na
        f32 = 9 * M * nn * K                 # anchor weights
        mm = 2 * M * nn * K * c + 2 * M * K * c * d
    elif name in ('intra_conv_prenorm_df', 'intra_conv_prenorm_dw'):
        df = name.endswith('df')
        f = args[1 if df else 0]
        b, p, na, c = f.shape
        K, d = (args[5].shape[0], args[5].shape[2]) if df else \
            (args[2].shape[1], args[3].shape[3])
        bf16 = f.dtype == torch.bfloat16
        mm = 2 * b * p * na * K * c * d
        # the fold and activation (dW: on load), or the mask, df and the two
        # sums (df)
        f32 = (7 if df else 3) * f.numel()
    elif name.startswith('intra_conv'):
        f = args[0]
        b, p, na, c = f.shape
        W = {'intra_conv': 2, 'intra_conv_df': 3,
             'intra_conv_prenorm': 3}.get(name)
        if W is None:                        # dW: [K, c, d] from f and dout
            K, d = args[1].shape[1], args[2].shape[3]
        else:
            K, c, d = args[W].shape
        bf16 = f.dtype == torch.bfloat16
        mm = 2 * b * p * na * K * c * d
        if name == 'intra_conv_prenorm':
            f32 = 3 * f.numel()              # the fold and activation
    elif name == 'moments':
        f32 = 3 * args[0].numel()
    elif name == 'grouped_conv_bwd':
        # dx = dout W^T and dW = x^T dout (each 2 M c d), dbias's sums
        x, W, parts = args[0], args[1], args[3]
        M = x.numel() // W.shape[0]
        bf16 = x.dtype == torch.bfloat16
        mm = 2 * M * W.numel() * ((parts & 1) + (parts >> 1 & 1))
        f32 = M * W.shape[1] if parts & 2 else 0
    elif name.startswith('grouped_conv'):
        x, W = args[0], args[1]
        M = x.numel() // W.shape[0]
        bf16 = x.dtype == torch.bfloat16
        mm = 2 * M * W.shape[0] * W.shape[1]
        f32 = (8 if name == 'grouped_conv_tail' else 1) * M * W.shape[1]
    else:
        raise KeyError(name)
    return nb, (f32 + (0 if bf16 else mm)), (mm if bf16 else 0)


def bound_ms(name, args, out):
    """(bytes ms, operations ms) of the least time the card could take for
    one call: bytes over the memory rate, operations over their peak."""
    nb, f32, b16 = work(name, args, out)
    return 1e3 * nb / HBM_BYTES_S, 1e3 * max(f32 / PEAK_FP32,
                                             b16 / PEAK_BF16)


def rel_err(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


class compute_dtype:
    """The port's compute dtype inside the block, fp32 after it."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from epn_pointcloud_tpu_torch.ops import so3conv
        so3conv.set_compute_dtype(self.name)

    def __exit__(self, *exc):
        from epn_pointcloud_tpu_torch.ops import so3conv
        so3conv.set_compute_dtype('fp32')


def time_ms(fn, reps=10, warmup=3):
    """Median device ms of one call of ``fn``: CUDA events around a run of
    calls (as many as take ~1 ms, at most 20; one for a call of 1 ms or
    more), so that a short kernel's time is not its host launch cost."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n
    inner = min(20, max(1, math.ceil(1.0 / max(run(1), 1e-3))))
    return statistics.median(run(inner) for _ in range(reps))


def time_abba(a, b, timer=time_ms):
    """(a ms, b ms) by ``timer``, timed a, b, b, a and averaged a pair:
    two versions of a kernel compared in one run."""
    a0, b0, b1, a1 = timer(a), timer(b), timer(b), timer(a)
    return (a0 + a1) / 2, (b0 + b1) / 2


def device_ms(fn, calls=20, reps=10):
    """Median device ms of one call of ``fn``, for calls too short for
    ``time_ms`` (whose events wrap the wrapper's host work too): ``calls``
    back-to-back calls captured once into a CUDA graph, its replays timed
    with CUDA events, the median of ``reps`` replays over ``calls``. The
    wrappers launch on the current stream, so the capture takes them; a
    call that cannot be captured raises (no fallback to the host timer)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def synthetic_batch(b, n, seed):
    """b normalized synthetic clouds of n points (the test-split shapes)."""
    import numpy as np
    from epn_pointcloud_tpu_torch.data import pc as pctk
    from epn_pointcloud_tpu_torch.data import synthetic
    rng = np.random.RandomState(seed)
    clouds = [pctk.normalize_np(synthetic.make_shape(rng, n, i % 8).T).T
              for i in range(b)]
    return np.stack(clouds).astype(np.float32)


def full_opt(dataset_path='unused'):
    from epn_pointcloud_tpu_torch.app import config
    opt = config.parse_args(['experiment', '-d', dataset_path])
    opt.model.model = 'cls_so3net_pn'
    opt.model.flag = 'attention'
    return opt


def phase_build():
    from epn_pointcloud_tpu_torch.ops.kernels import build
    t0 = time.time()
    build.library()
    dt = time.time() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'kernels_build.log'), 'w') as f:
        f.write(build.build_log)
    for line in build.build_log.splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'[build] {line.strip()}')
    log(f'[build] kernels built and loaded in {dt:.1f} s')
    tensor_core_sass(build.lib_path)


# the bf16 kernels that run on tensor cores: the grouped conv forward and
# backward, the W-fused inter conv forward, the W-off F, the intra conv
# forward and B6 df, the inter backward scatter (the fused dTable and the
# W-off dG), the fused inter dW, the intra dW (B6 dW and the plain form's)
TC_KERNELS = ('grouped_conv_mma_kernel', 'grouped_bwd_mma_kernel',
              'inter_conv_mma_kernel', 'inter_f_mma_kernel',
              'intra_conv_mma_kernel', 'inter_bwd_mma_kernel',
              'inter_dw_mma_kernel', 'intra_dw_mma_kernel')
# the fp32 kernels held to full fp32 products on the CUDA cores: the
# W-fused inter forward, the fused inter dW, the inter backward scatter
# (the fused dTable and the W-off dG), the W-off F, the intra dW, the intra
# forward (and df), the ones conv (both output types)
FFMA_KERNELS = ('inter_fwd_f32_kernel', 'inter_dw_f32_kernel',
                'inter_bwd_f32_kernel', 'inter_f_f32_kernel',
                'intra_dw_f32_kernel', 'intra_fwd_f32_kernel',
                'ones_conv_kernel')


def tensor_core_sass(so):
    """Count the tensor-core instructions (HMMA, GMMA) in the SASS of each
    instantiation of the bf16 tensor-core kernels and of the fp32 CUDA-core
    kernels in the built library (cuobjdump -sass), and the latter's FFMA;
    written to chiprun_out/kernels_sass_mma.txt. Fails if a kernel has no
    instantiation, a bf16 one has no tensor-core instruction, or an fp32
    one has one (no TF32) or no FFMA."""
    cuobjdump = shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', so], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split('Function :', 1)[1].strip()
            fn = name if any(k in name for k in TC_KERNELS + FFMA_KERNELS) \
                else None
            if fn:
                counts[fn] = {'HMMA': 0, 'GMMA': 0, 'FFMA': 0}
        elif fn:
            for op in ('HMMA', 'GMMA', 'FFMA'):
                counts[fn][op] += op in line
    lines = [f'{c["HMMA"]} HMMA {c["GMMA"]} GMMA {c["FFMA"]} FFMA {fn}'
             for fn, c in sorted(counts.items())]
    with open(os.path.join(OUT_DIR, 'kernels_sass_mma.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    per = {k: [c['HMMA'] + c['GMMA'] for fn, c in counts.items() if k in fn]
           for k in TC_KERNELS}
    for k, n in per.items():
        log(f'[build] SASS {k}: {len(n)} instantiations, tensor-core '
            f'instructions {min(n, default=0)}..{max(n, default=0)} each')
    if not all(per.values()) or min(min(n) for n in per.values()) == 0:
        raise AssertionError(f'bf16 kernels without tensor-core '
                             f'instructions: {per}')
    for k in FFMA_KERNELS:
        cs = [c for fn, c in counts.items() if k in fn]
        log(f'[build] SASS {k}: {len(cs)} instantiations, FFMA '
            f'{" ".join(str(c["FFMA"]) for c in cs)}, HMMA + GMMA '
            f'{sum(c["HMMA"] + c["GMMA"] for c in cs)}')
        if not cs or any(c['HMMA'] or c['GMMA'] or not c['FFMA']
                         for c in cs):
            raise AssertionError(f'{k}: not FFMA alone: {cs}')


def capture_calls(names, run):
    """Run ``run()``, recording each outermost call of the named kernel
    wrappers (module function names in ops/kernels) as (name, args)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    mods = {n: m for m in kernels.MODULES for n in names if hasattr(m, n)}
    calls = []
    saved = {n: getattr(m, n) for n, m in mods.items()}

    depth = [0]

    def recorder(name, orig):
        def rec(*args):
            # a wrapper that calls another (intra df runs the forward
            # wrapper) is recorded once, as itself
            if depth[0] == 0:
                calls.append((name, args))
            depth[0] += 1
            try:
                return orig(*args)
            finally:
                depth[0] -= 1
        return rec
    for n, m in mods.items():
        setattr(m, n, recorder(n, saved[n]))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for n, m in mods.items():
            setattr(m, n, saved[n])
    return calls


class recording:
    """Inside the block, each call of the kernel wrapper ``name`` (a module
    function in ops/kernels) is recorded as (args, output): the calls of
    the step being run, for a check after it that launches nothing."""

    def __init__(self, name):
        from epn_pointcloud_tpu_torch.ops import kernels
        self.name = name
        self.module = next(m for m in kernels.MODULES if hasattr(m, name))
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def rec(*args):
            out = self.orig(*args)
            self.calls.append((args, out))
            return out
        setattr(self.module, self.name, rec)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def check_dw_calls(tag, calls, routes, n_expect):
    """Every B6 dW call of a bf16 step (``calls``: (args, dW) recorded by
    ``recording``) within 1e-3 (normwise) of intra_conv_prenorm_dw_plain on
    its own inputs, finite, and all ``n_expect`` of them on the tensor-core
    dW (``routes``: ``route_counts()`` read after the step)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    plain = kernels.intra_conv.intra_conv_prenorm_dw_plain
    rels = []
    with torch.no_grad():
        for args, dW in calls:
            rels.append(rel_err(dW, plain(*args)))
            assert bool(torch.isfinite(dW).all()), f'{tag} non-finite dW'
    intra = routes['intra']
    log(f'{tag} B6 dW: {len(calls)} calls, on the tensor-core dW '
        f'dw_mma={intra["dw_mma"]} (SGEMM dw={intra["dw"]}); rel_norm_err '
        f'vs intra_conv_prenorm_dw_plain per call '
        f'{" ".join(f"{r:.2e}" for r in rels)} (<= 1e-3)')
    assert len(calls) == n_expect and intra['dw_mma'] == n_expect and \
        intra['dw'] == 0, (len(calls), intra, n_expect)
    assert max(rels, default=0.0) <= 1e-3, rels
    return rels


def _shape_desc(name, args):
    if name == 'fps':
        return f'xyz {tuple(args[0].shape)} -> {args[1]}'
    if name == 'ball_query':
        return (f'query {tuple(args[0].shape)} support {tuple(args[1].shape)}'
                f' ns={args[3]} r={args[2]:.4f}')
    if name == 'inter_conv':
        gx, idx, tab, W = args[0], args[1], args[2], args[5]
        return (f'b={tab.shape[0]} p1={tab.shape[1]} p2={idx.shape[1]} '
                f'nn={idx.shape[2]} c={tab.shape[3]} d={W.shape[2]} '
                f'sigma={args[6]:.4f}')
    if name in ('inter_conv_dtable', 'inter_conv_dw'):
        idx, rk = args[1], args[3]
        c, d = ((args[5].shape[1], args[5].shape[2])
                if name == 'inter_conv_dtable' else
                (args[2].shape[3], args[5].shape[-1]))
        return (f'b={idx.shape[0]} p2={idx.shape[1]} nn={idx.shape[2]} '
                f'na={rk.shape[0]} c={c} d={d} sigma={args[-1]:.4f}')
    if name in ('inter_conv_f', 'inter_conv_dg'):
        idx = args[1]
        c = args[2 if name == 'inter_conv_f' else 5].shape[-1]
        return (f'b={idx.shape[0]} p2={idx.shape[1]} nn={idx.shape[2]} c={c} '
                f'sigma={args[-1]:.4f}')
    if name == 'ones_conv':
        return (f'gx {tuple(args[0].shape)} -> F {args[4]} '
                f'sigma={args[3]:.4f}')
    if name == 'moments':
        return f'x {tuple(args[0].shape)} {args[0].dtype}'
    if name.startswith('grouped_conv'):
        x, W = args[0], args[1]
        return (f'b={x.shape[0]} p={x.shape[1]} c={W.shape[0]} '
                f'd={W.shape[1]} {x.dtype}')
    f, W = args[0], args[3 if name == 'intra_conv_prenorm' else 2]
    return (f'b={f.shape[0]} p={f.shape[1]} c={f.shape[3]} d={W.shape[2]} '
            f'{f.dtype}')


def _aggregate(rows):
    """Sums of a kernel's per-call rows: its time, plain time, bound and
    library time over the layers of one forward or step."""
    bytes_ms = sum(r['bytes_ms'] for r in rows)
    ops_ms = sum(r['ops_ms'] for r in rows)
    lib = [r.get('library_ms') for r in rows]
    agg = {'max_abs_err': max(r['max_abs_err'] for r in rows),
           'ms': sum(r['ms'] for r in rows),
           'plain_ms': sum(r['plain_ms'] for r in rows),
           'bound_ms': sum(max(r['bytes_ms'], r['ops_ms']) for r in rows),
           'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
           'library_ms': None if None in lib else sum(lib),
           'calls': len(rows)}
    # the inter forward's yardsticks (inter_conv_extras), the device
    # timer's (device_extras), the earlier tree's kernels (--parent-csrc)
    for key in ('composed_ms', 'parent_ms', 'same_timer_ms', 'device_ms',
                'library_ms_device', 'refactor_parent_ms', 'refactor_ms'):
        vals = [r.get(key) for r in rows]
        if None not in vals:
            agg[key] = sum(vals)
    for key in ('composed_peak_gib', 'kernel_peak_gib'):
        vals = [r.get(key) for r in rows]
        if None not in vals:
            agg[key] = max(vals)
    return agg


FWD = ('fps', 'ball_query', 'ones_conv', 'inter_conv', 'intra_conv')


def phase_kernels(model, device):
    """Each kernel vs its plain version at every flagship layer shape."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(device)

    def run():
        with torch.no_grad():
            model(x)
    calls = capture_calls(FWD, run)
    entries = {k.name: k for k in kernels.KERNELS}
    results = {n: [] for n in FWD}
    layer_of = dict.fromkeys(FWD, 0)
    failures = []
    for name, args in calls:
        kw = {}
        # model layer: the inter conv kernel starts at layer 1 (layer 0's
        # occupancy-ones input runs the ones conv)
        layer = layer_of[name] + (1 if name == 'inter_conv' else 0)
        layer_of[name] += 1
        kern_fn = getattr(entries[name].module, name)
        plain_fn = getattr(entries[name].module, entries[name].plain)
        got = kern_fn(*args, **kw)
        want = plain_fn(*args, **kw)
        torch.cuda.synchronize()
        if name in ('fps', 'ball_query'):
            ok = torch.equal(got, want)
            max_err = float((got.long() - want.long()).abs().max())
            rel = max_err
            tol = 'exact'
        else:
            depth = 24 * args[2].shape[-1] if name == 'inter_conv' else \
                24 * args[0].shape[-1]
            diff = (got - want).abs()
            max_err = float(diff.max())
            rel = float((got - want).norm() / want.norm())
            rtol = max(1e-5, depth * 1.3e-7)
            within = bool((diff <= 1e-4 + rtol * want.abs()).all())
            ok = rel <= 1e-5 and within and bool(torch.isfinite(got).all())
            tol = f'rel_norm<=1e-5, rtol={rtol:.2e}, atol=1e-4'
        k_ms = time_ms(lambda: kern_fn(*args, **kw),
                       reps=5 if name == 'fps' else 10)
        p_ms = time_ms(lambda: plain_fn(*args, **kw),
                       reps=5 if name == 'fps' else 10)
        b_ms, o_ms = bound_ms(name, args, got)
        desc = _shape_desc(name, args)
        row = {'layer': layer, 'shape': desc, 'max_abs_err': max_err,
               'rel_norm_err': rel, 'ms': k_ms, 'plain_ms': p_ms,
               'bytes_ms': b_ms, 'ops_ms': o_ms,
               **mm_library(name, args), **intra_conv_extras(name, args, got),
               **inter_conv_extras(name, args, got),
               **sampling_extras(name, args, got), **device_extras(name, args),
               **ones_conv_extras(name, args, got)}
        ok = ok and _extras_ok(row)
        row['ok'] = ok
        log(f'[compare] {name} L{layer} ({desc}): max_abs_err={max_err:.3e} '
            f'rel_norm_err={rel:.3e} [{tol}] kernel_ms={k_ms:.4f} '
            f'plain_ms={p_ms:.4f}{_library_note(row)} bound_ms='
            f'{max(b_ms, o_ms):.4f} {"OK" if ok else "FAIL"}')
        results[name].append(row)
        if not ok:
            failures.append(f'{name} L{layer}')
        del got, want
    expect = {'fps': 1, 'ball_query': 7, 'ones_conv': 1, 'inter_conv': 6,
              'intra_conv': 7}
    for name, n in expect.items():
        if len(results[name]) != n:
            failures.append(f'{name}: {len(results[name])} calls in one '
                            f'forward, expected {n}')
    if failures:
        raise AssertionError(f'kernel comparisons failed: {failures}')
    check_fp32_rows('[compare]', results['intra_conv'], expect['intra_conv'],
                    'intra forward', 'torch.mm(A, W)', 1.5, 'fwd_f32', 1e-5)
    check_fp32_rows('[compare]', results['inter_conv'], expect['inter_conv'],
                    'inter forward', INTER_YARD, 1.5, 'fwd_f32', 1e-5,
                    'composed_ms')
    return results


def phase_model(model, device):
    """Full forward at b=8: kernel path vs plain path on the card."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(8, N_POINTS, SEED + 1)).to(device)
    with torch.no_grad():
        k_logits, k_att = model(x)
        with kernels.plain():
            p_logits, p_att = model(x)
    torch.cuda.synchronize()
    err = float((k_logits - p_logits).abs().max())
    log(f'[model] b=8 logits {tuple(k_logits.shape)} kernel vs plain '
        f'max_abs_err={err:.3e} (rtol=1e-3, atol=2e-3); attention logits '
        f'max_abs_err={float((k_att - p_att).abs().max()):.3e}')
    assert k_logits.shape == (8, 40) and torch.isfinite(k_logits).all()
    torch.testing.assert_close(k_logits, p_logits, rtol=1e-3, atol=2e-3)
    torch.testing.assert_close(k_att, p_att, rtol=1e-3, atol=2e-3)
    return err


def phase_forward_time(model, device, reps=5, dtype='fp32'):
    """Whole b=32 forward on the card, kernel path and plain path in turns
    (CUDA events; the median of each)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED + 2)).to(device)

    def plain_fwd():
        with kernels.plain():
            model(x)
    k_ts, p_ts = [], []
    with torch.no_grad(), compute_dtype(dtype):
        model(x)
        plain_fwd()
        for _ in range(reps):
            k_ts.append(time_ms(lambda: model(x), reps=1, warmup=0))
            p_ts.append(time_ms(plain_fwd, reps=1, warmup=0))
    k_ms, p_ms = statistics.median(k_ts), statistics.median(p_ts)
    log(f'[forward] b={BATCH} {dtype} whole forward: kernel path {k_ms:.2f} ms '
        f'({1e3 * BATCH / k_ms:.1f} clouds/s), plain path {p_ms:.2f} ms '
        f'({1e3 * BATCH / p_ms:.1f} clouds/s); median of {reps} turns')
    return {'kernel_ms': k_ms, 'plain_ms': p_ms, 'kernel_runs_ms': k_ts,
            'plain_runs_ms': p_ts}


def route_counts():
    """The inter and intra wrappers' launches by kernel ('mma': the bf16
    tensor-core kernel, 'fwd_f32': the fp32 CUDA-core kernel, 'sgemm': the
    SGEMM): the W-fused inter forward's
    (with the backward scatter's, the fused dW's and the W-off F's:
    'dtable_mma' / 'dg_mma' / 'dw_mma' / 'f_mma', the bf16 tensor-core
    kernels, 'dtable_f32' / 'dg_f32' / 'dw_f32', the fp32 CUDA-core
    kernels, or 'dtable' / 'dg' / 'dw' / 'f', the templates), and the intra
    forward's with B6 df's (with dW's: 'dw_mma', the bf16 tensor-core
    kernel, 'dw_f32', the fp32 CUDA-core kernel, or 'dw', the SGEMM); and
    fps's ('reg': the cloud in registers, 'smem': in shared memory) and
    ball_query's ('warp': lanes a query, 'thread': a thread a query)."""
    from epn_pointcloud_tpu_torch.ops import kernels
    return {'fps': dict(kernels.fps.routes),
            'ball_query': dict(kernels.ball_query.routes),
            'inter': dict(kernels.inter_conv.routes),
            'intra': dict(kernels.intra_conv.routes)}


def check_routes(tag, dtype, counts, routes):
    """Every W-fused inter forward, every fused dTable, W-off dG, fused dW
    and W-off F, and every intra forward, B6 df and intra dW, of an entry
    run went
    through the kernel of its dtype: the tensor-core kernels in bf16; in
    fp32 the CUDA-core kernels of the inter forward ('fwd_f32'; the SGEMM
    template 'sgemm' nowhere), the fused dW ('dw_f32'), the backward
    scatter ('dtable_f32', 'dg_f32') and the W-off F ('f_f32'), of the
    intra forward and df ('fwd_f32'; the SGEMM 'sgemm' nowhere) and of the
    intra dW ('dw_f32'; the SGEMM 'dw' nowhere), and every fps on its
    register kernel ('reg') and ball query
    on its warp kernel ('warp') (``routes``: ``route_counts()``, read with
    ``counts``)."""
    want = {'fps': {'reg': counts['fps'], 'smem': 0},
            'ball_query': {'warp': counts['ball_query'], 'thread': 0}}
    for conv, n in (('inter', counts['inter_conv']),
                    ('intra', counts['intra_conv']
                     + counts['intra_conv_prenorm']
                     + counts['intra_conv_prenorm_df'])):
        assert n > 0, (conv, counts)
        want[conv] = ({'mma': n, 'sgemm': 0} if dtype == 'bf16' else
                      {'mma': 0, 'sgemm': n})
    # the inter forward and the intra forward and df in fp32: their
    # CUDA-core kernels (the inter template and the intra prenorm form's
    # SGEMM on no fp32 model path)
    for conv in ('inter', 'intra'):
        want[conv].update({'fwd_f32': 0} if dtype == 'bf16' else
                          {'sgemm': 0, 'fwd_f32': want[conv]['sgemm']})
    for conv, entry, n in (
            ('inter', 'dtable', counts['inter_conv_dtable']),
            ('inter', 'dg', counts['inter_conv_dg']),
            ('inter', 'dw', counts['inter_conv_dw']),
            ('inter', 'f', counts['inter_conv_f']),
            ('intra', 'dw', counts['intra_conv_dw']
             + counts['intra_conv_prenorm_dw'])):
        want[conv].update({f'{entry}_mma': n, entry: 0} if dtype == 'bf16'
                          else {f'{entry}_mma': 0, entry: n})
    # the fused inter dW, the backward scatter and the W-off F in fp32:
    # their CUDA-core kernels, not the templates
    for entry in ('dtable', 'dg', 'dw', 'f'):
        n = counts[f'inter_conv_{entry}']
        want['inter'].update({f'{entry}_f32': 0} if dtype == 'bf16' else
                             {entry: 0, f'{entry}_f32': n})
    # the intra dW in fp32: its CUDA-core kernel (the plain form; the
    # prenorm form's SGEMM on no fp32 model path)
    n = counts['intra_conv_dw'] + counts['intra_conv_prenorm_dw']
    want['intra'].update({'dw_f32': 0} if dtype == 'bf16' else
                         {'dw': 0, 'dw_f32': n})
    log(f'{tag} launches by kernel: {routes}')
    assert routes == want, (routes, want)


def phase_eval(dtype='fp32'):
    """A main path: run_modelnet eval on a synthetic test tree, in fp32, or
    in the bf16 production mode (this slice's)."""
    import torch
    from epn_pointcloud_tpu_torch import run_modelnet
    from epn_pointcloud_tpu_torch.data import synthetic
    from epn_pointcloud_tpu_torch.ops import kernels, so3conv
    tree = os.path.join(WORK_DIR, 'modelnet')
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    synthetic.make_modelnet_tree(tree, n_cats=4, n_train=0, n_test=16,
                                 n_points=N_POINTS, seed=0, splits=('testR',))
    argv = ['experiment', '-d', tree, '--run-mode', 'eval', '-b', str(BATCH),
            '--compute-dtype', dtype, '--model-dir',
            os.path.join(WORK_DIR, 'runs')]
    try:
        kernels.reset_counts()
        t0 = time.time()
        trainer = run_modelnet.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.counts()
        routes = route_counts()
    finally:
        so3conv.set_compute_dtype('fp32')
    trainer.logger.close()
    check_routes('[eval]', dtype, counts, routes)
    n_batches = len(trainer.eval_logits)
    logits = torch.cat(trainer.eval_logits)
    log(f'[eval] run_modelnet eval --compute-dtype {dtype}: {n_batches} '
        f'batches of {BATCH}, logits {tuple(logits.shape)} {logits.dtype}, '
        f'accuracy {trainer.test_accs[-1]:.2f}%, wall {wall:.2f} s (data and '
        f'setup included); kernel launches {counts}')
    assert n_batches >= 2 and logits.shape == (n_batches * BATCH, 40)
    assert torch.isfinite(logits).all(), 'non-finite eval logits'
    per = EVAL_PER_BATCH if dtype == 'fp32' else BF16_EVAL_PER_BATCH
    expect = {n: k * n_batches for n, k in per.items()}
    assert counts == expect, (counts, expect)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return counts, n_batches


# kernel launches of one eval batch, and of one train step: the forward's,
# plus the backward's: intra df runs the forward intra kernel on the inverse
# adjacency (7 more), dTable and dW at the 6 inter layers with a feature
# table, intra dW at all 7; the layer-0 ones conv has no backward (its VJP is
# zero: F depends on the coordinates only)
_NO_BF16 = {'intra_conv_prenorm': 0, 'moments': 0, 'grouped_conv': 0,
            'grouped_conv_tail': 0, 'intra_conv_prenorm_df': 0,
            'intra_conv_prenorm_dw': 0, 'grouped_conv_bwd': 0}
# the W-off inter conv runs only where the backward composes (c <= 32 or
# nn > 32): never in cls_so3net_pn
_NO_WOFF = {'inter_conv_f': 0, 'inter_conv_dg': 0}
EVAL_PER_BATCH = {'fps': 1, 'ball_query': 7, 'ones_conv': 1, 'inter_conv': 6,
                  'inter_conv_dtable': 0, 'inter_conv_dw': 0,
                  'intra_conv': 7, 'intra_conv_dw': 0, **_NO_BF16,
                  **_NO_WOFF}
TRAIN_PER_STEP = {'fps': 1, 'ball_query': 7, 'ones_conv': 1, 'inter_conv': 6,
                  'inter_conv_dtable': 6, 'inter_conv_dw': 6,
                  'intra_conv': 14, 'intra_conv_dw': 7, **_NO_BF16,
                  **_NO_WOFF}
# the bf16 production eval: every intra layer runs the prenorm form and its
# InstanceNorm statistics through moments; layers 1-6 end in the fused tail
# (layer 0's rank-1 skip keeps the unfused one); the head's mlp conv is the
# grouped conv
BF16_EVAL_PER_BATCH = {**_NO_BF16, **_NO_WOFF, 'fps': 1, 'ball_query': 7,
                       'ones_conv': 1,
                       'inter_conv': 6, 'inter_conv_dtable': 0,
                       'inter_conv_dw': 0, 'intra_conv': 0,
                       'intra_conv_dw': 0, 'intra_conv_prenorm': 7,
                       'moments': 7, 'grouped_conv': 1,
                       'grouped_conv_tail': 6}
# one bf16 train step: the training forward (no fused tail: the skip
# BatchNorms take batch statistics) and its backward. moments: 7 inter
# BatchNorms, 7 InstanceNorms, the packed skip BatchNorms of layers 1-6 and
# the head's (layer 0's rank-1 skip over the constant field runs unpacked, in
# plain torch, as in the JAX package); the grouped conv at those 6 skips and
# the head's mlp, forward and backward; bf16 dTable and dW at the 6 inter
# layers with a feature table; the prenorm intra df and dW at all 7
BF16_TRAIN_PER_STEP = {**BF16_EVAL_PER_BATCH, 'inter_conv_dtable': 6,
                       'inter_conv_dw': 6, 'intra_conv_prenorm_df': 7,
                       'intra_conv_prenorm_dw': 7, 'moments': 21,
                       'grouped_conv': 7, 'grouped_conv_tail': 0,
                       'grouped_conv_bwd': 7}
BF16_FWD = ('fps', 'ball_query', 'ones_conv', 'inter_conv',
            'intra_conv_prenorm', 'moments', 'grouped_conv_tail',
            'grouped_conv')
# the kernels whose bf16 calls are compared here (fps and ball_query take
# the same fp32 coordinates in both modes: compared in the fp32 phase)
BF16_COMPARED = BF16_FWD[2:]


def phase_bf16_kernels(model, device):
    """Each kernel call of a b=32 bf16 forward against its plain version on
    the same inputs (normwise <= 4e-3 for bf16 outputs, <= 1e-5 for the
    moments' fp32 sums), timed, with torch.addmm beside the grouped conv;
    every inter conv call on the tensor-core kernel, bitwise equal on a
    second call, within 1e-3 of inter_conv_mma_plain, and timed beside the
    composition it spares (``inter_conv_extras``)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(device)

    def run():
        with torch.no_grad():
            model(x)
    with compute_dtype('bf16'):
        calls = capture_calls(BF16_FWD, run)
    entries = {k.name: k for k in kernels.KERNELS}
    n_calls = {n: sum(1 for c in calls if c[0] == n) for n in BF16_FWD}
    results = {n: [] for n in BF16_COMPARED}
    failures = []
    torch.set_grad_enabled(False)
    for name, args in calls:
        if name not in BF16_COMPARED:
            continue
        # model layer: the inter conv and the fused tail start at layer 1
        # (layer 0 runs the ones conv and the unfused tail); the grouped
        # conv's one call is the head's
        layer = len(results[name]) + (1 if name in ('inter_conv',
                                                    'grouped_conv_tail')
                                      else 0)
        kern_fn = getattr(entries[name].module, name)
        plain_fn = getattr(entries[name].module, entries[name].plain)
        got, want = kern_fn(*args), plain_fn(*args)
        torch.cuda.synchronize()
        if name == 'moments':
            rel = max(rel_err(g, w) for g, w in zip(got, want))
            max_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            tol = 1e-5
            finite = all(bool(torch.isfinite(g).all()) for g in got)
        else:
            rel = rel_err(got, want)
            max_err = float((got.float() - want.float()).abs().max())
            tol = 1e-5 if got.dtype == torch.float32 else 4e-3
            finite = bool(torch.isfinite(got).all())
        ok = rel <= tol and finite
        k_ms = time_ms(lambda: kern_fn(*args))
        p_ms = time_ms(lambda: plain_fn(*args))
        row = {'layer': layer, 'shape': _shape_desc(name, args),
               'max_abs_err': max_err, 'rel_norm_err': rel, 'ms': k_ms,
               'plain_ms': p_ms, 'ok': ok}
        row['bytes_ms'], row['ops_ms'] = bound_ms(name, args, got)
        row.update(grouped_library(name, args))
        row.update(moments_library(name, args))
        row.update(device_extras(name, args))
        row.update(ones_conv_extras(name, args, got))
        row.update(inter_conv_extras(name, args, got))
        row.update(intra_conv_extras(name, args, got))
        ok = ok and _extras_ok(row)
        row['ok'] = ok
        lib = _library_note(row)
        log(f'[bf16] {name} L{layer} ({row["shape"]}): max_abs_err='
            f'{max_err:.3e} rel_norm_err={rel:.3e} [rel_norm<={tol:.0e}] '
            f'kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}{lib} bound_ms='
            f'{max(row["bytes_ms"], row["ops_ms"]):.4f} '
            f'{"OK" if ok else "FAIL"}')
        results[name].append(row)
        if not ok:
            failures.append(f'{name} L{layer}')
        del got, want
    torch.set_grad_enabled(True)
    if n_calls != {n: BF16_EVAL_PER_BATCH[n] for n in BF16_FWD}:
        failures.append(f'bf16 forward calls {n_calls}')
    if failures:
        raise AssertionError(f'bf16 kernel comparisons failed: {failures}')
    return results


def _cosine(a, b):
    import torch
    return torch.nn.functional.cosine_similarity(a.double(), b.double(),
                                                 dim=-1)


def phase_bf16_model(model, device):
    """b=8 bf16 logits, kernel path vs plain path (per-sample cosine >=
    0.9999); b=32 bf16 vs fp32 kernel paths (minimum cosine >= 0.999)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x8 = torch.from_numpy(synthetic_batch(8, N_POINTS, SEED + 1)).to(device)
    x32 = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED + 2)).to(
        device)
    with torch.no_grad():
        with compute_dtype('bf16'):
            k8 = model(x8)[0]
            with kernels.plain():
                p8 = model(x8)[0]
            k32 = model(x32)[0]
        f32 = model(x32)[0]
    torch.cuda.synchronize()
    cos8, cos32 = _cosine(k8, p8), _cosine(k32, f32)
    log(f'[bf16-model] b=8 bf16 logits kernel vs plain path: min cosine '
        f'{float(cos8.min()):.7f} (>= 0.9999), max abs diff '
        f'{float((k8 - p8).abs().max()):.3e}; b={BATCH} bf16 vs fp32 kernel '
        f'path: min cosine {float(cos32.min()):.7f} (>= 0.999), mean '
        f'{float(cos32.mean()):.7f}')
    assert k8.dtype == torch.float32 and torch.isfinite(k8).all()
    assert torch.isfinite(k32).all()
    assert float(cos8.min()) >= 0.9999, cos8
    assert float(cos32.min()) >= 0.999, cos32
    return {'b8_kernel_vs_plain_min_cos': float(cos8.min()),
            'b32_bf16_vs_fp32_min_cos': float(cos32.min())}


def train_batch(device, seed):
    """(clouds [12, 1024, 3], class labels, anchor labels) on the card."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    x = synthetic_batch(TRAIN_BATCH, N_POINTS, seed)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(rng.randint(0, 40, TRAIN_BATCH)).to(device),
            torch.from_numpy(rng.randint(0, 60, TRAIN_BATCH)).to(device))


def step_loss(model, batch):
    """Forward and the training loss (attention CE, 'default', margin 1)."""
    from epn_pointcloud_tpu_torch import losses
    pred, feat = model(batch[0])
    return losses.attention_cross_entropy(pred, batch[1], feat, batch[2],
                                          'default', 1.0)[0]


def _grads_close(name, g, w, f64_max):
    """The per-leaf rule of tests/test_reference_train_parity.py: relative
    L2 <= 1e-2 and max error <= 5e-2 * max|g|. A leaf whose float64
    gradient is ~0 (<= 1e-5: BN-invariant biases, the block-0
    constant-field branch) has no fp32 value to compare relatively, only
    rounding noise from a plain-torch branch both paths share: the two must
    agree within 2e-3 absolute. So must leaves where both are <= 1e-3, and
    then the float64 gradient must be <= 1e-3 too (no real gradient
    masked)."""
    err = float((g - w).abs().max())
    tiny = max(float(g.abs().max()), float(w.abs().max())) <= 1e-3
    if f64_max <= 1e-5 or tiny:
        return (err <= 2e-3 and f64_max <= 1e-3,
                f'{name}: degenerate (fp64 max {f64_max:.1e}), '
                f'max|diff|={err:.3e}')
    scale = float(w.abs().max())
    l2 = float((g - w).norm() / w.norm())
    return (err <= 5e-2 * scale and l2 <= 1e-2,
            f'{name}: max|diff|={err:.3e} (scale {scale:.3e}) relL2={l2:.3e}')


def f64_grad_max(model, batch):
    """Per-leaf max |gradient| of a float64 copy of ``model`` on the plain
    path (the exact-arithmetic stand-in that marks degenerate leaves)."""
    import copy
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    m64 = copy.deepcopy(model).double()
    with kernels.plain():
        step_loss(m64, (batch[0].double(),) + batch[1:]).backward()
    out = {n: float(p.grad.abs().max()) if p.grad is not None else 0.0
           for n, p in m64.named_parameters()}
    del m64
    torch.cuda.empty_cache()
    return out


def perturb_norm_biases(model, seed=5):
    """Shift every norm bias off zero, as tests/test_reference_train_parity.py
    does: at init the block-0 skip branch is a BatchNorm over a constant
    field, whose output is 0 up to rounding, so its leaky-ReLU mask and the
    gradients behind it are rounding noise (~1e-2 here), not a quantity two
    paths can agree on. Off zero, the mask is fixed and those gradients are
    the exact zeros they are meant to be, up to noise <= 1e-3."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if '.norm.' in name and name.endswith('.bias'):
                p += torch.from_numpy(
                    0.3 * rng.randn(*p.shape).astype(np.float32)).to(p.device)
    return model


def time_steps(mk, mp, batch, dtype, reps, loss=step_loss, tag=None,
               n_clouds=TRAIN_BATCH):
    """The whole train step (forward, ``loss``, backward, Adam) in
    ``dtype``, kernel path on ``mk`` and plain path on ``mp`` in turns,
    after one warm step each: (the kernel path's optimizer, median kernel
    ms, median plain ms, and the runs)."""
    from epn_pointcloud_tpu_torch import train
    from epn_pointcloud_tpu_torch.ops import kernels
    opt_k = train.make_optimizer(mk.parameters(), 1e-3)
    opt_p = train.make_optimizer(mp.parameters(), 1e-3)

    def step_k():
        opt_k.zero_grad(set_to_none=True)
        loss(mk, batch).backward()
        opt_k.step()

    def step_p():
        with kernels.plain():
            opt_p.zero_grad(set_to_none=True)
            loss(mp, batch).backward()
            opt_p.step()
    k_ts, p_ts = [], []
    with compute_dtype(dtype):
        step_k()
        step_p()
        for _ in range(reps):
            k_ts.append(time_ms(step_k, reps=1, warmup=0))
            p_ts.append(time_ms(step_p, reps=1, warmup=0))
    k_ms, p_ms = statistics.median(k_ts), statistics.median(p_ts)
    tag = tag or ('[train]' if dtype == 'fp32' else '[bf16-train]')
    log(f'{tag} b={n_clouds} whole {dtype} train step (forward, backward, '
        f'Adam): kernel path {k_ms:.2f} ms ({1e3 * n_clouds / k_ms:.1f} '
        f'clouds/s), plain path {p_ms:.2f} ms ({1e3 * n_clouds / p_ms:.1f} '
        f'clouds/s); median of {reps} turns')
    return opt_k, k_ms, p_ms, k_ts, p_ts


def phase_train_step(device, reps=5):
    """One b=12 train step on the kernel path and on the plain path from the
    same weights (seeded, norm biases perturbed); then the whole step timed
    on both, and 10 Adam steps."""
    import torch
    from epn_pointcloud_tpu_torch import models
    from epn_pointcloud_tpu_torch.ops import kernels
    mk, mp = (perturb_norm_biases(models.build_model_from(
        full_opt(), seed=SEED)).to(device).train() for _ in range(2))
    batch = train_batch(device, SEED + 4)
    f64 = f64_grad_max(mp, batch)
    kernels.reset_counts()
    loss_k = step_loss(mk, batch)
    loss_k.backward()
    counts_k = kernels.counts()
    with kernels.plain():
        loss_p = step_loss(mp, batch)
        loss_p.backward()
    torch.cuda.synchronize()
    assert kernels.counts() == counts_k, 'the plain path launched a kernel'
    assert counts_k == TRAIN_PER_STEP, (counts_k, TRAIN_PER_STEP)
    lk, lp = loss_k.item(), loss_p.item()
    log(f'[train] b={TRAIN_BATCH} loss kernel path {lk:.7f}, plain path '
        f'{lp:.7f} (rtol 1e-5)')
    assert abs(lk - lp) <= 1e-5 * abs(lp), (lk, lp)
    bad, degen, worst = [], [], (0.0, '')
    pk = dict(mk.named_parameters())
    for name, p in mp.named_parameters():
        g = pk[name].grad
        ok, msg = _grads_close(name, g if g is not None else
                               torch.zeros_like(p), p.grad if p.grad is not
                               None else torch.zeros_like(p), f64[name])
        if not ok:
            bad.append(msg)
        elif 'degenerate' in msg:
            degen.append(msg)
        if f64[name] > 1e-5:
            l2 = float((pk[name].grad - p.grad).norm()
                       / p.grad.norm().clamp(min=1e-30))
            worst = max(worst, (l2, name))
    log(f'[train] gradients: {len(pk)} leaves, worst relative L2 '
        f'{worst[0]:.3e} at {worst[1]}; {len(degen)} degenerate leaves '
        f'(fp64 gradient <= 1e-5 or both <= 1e-3): {"; ".join(degen)}')
    assert not bad, bad
    bk = dict(mk.named_buffers())
    n_stats, stat_err = 0, 0.0
    for name, buf in mp.named_buffers():
        if 'running' in name:
            torch.testing.assert_close(bk[name], buf, rtol=1e-4, atol=1e-6)
            stat_err = max(stat_err, float((bk[name] - buf).abs().max()))
            n_stats += 1
    log(f'[train] BatchNorm running stats: {n_stats} buffers, max '
        f'abs diff {stat_err:.3e} (rtol 1e-4)')

    opt_k, k_ms, p_ms, k_ts, p_ts = time_steps(mk, mp, batch, 'fp32', reps)
    del mp
    torch.cuda.empty_cache()
    trace = []
    for i in range(11):
        loss = step_loss(mk, batch)
        trace.append(loss.item())
        if i < 10:
            opt_k.zero_grad(set_to_none=True)
            loss.backward()
            opt_k.step()
    log(f'[train] 10 Adam steps on one batch, kernel path: loss '
        f'{trace[0]:.4f} -> {trace[-1]:.4f}')
    assert all(map(math.isfinite, trace)) and trace[-1] < trace[0], trace
    return {'loss_kernel': lk, 'loss_plain': lp, 'kernel_ms': k_ms,
            'plain_ms': p_ms, 'kernel_runs_ms': k_ts, 'plain_runs_ms': p_ts,
            'worst_grad_rel_l2': worst[0], 'adam_trace': trace}


def grouped_library(name, args):
    """The one-call yardstick of a grouped conv call, timed on its inputs:
    torch.addmm for the forward, the two torch.mm of dx = dout W^T and dW =
    x^T dout for the backward (added); {} for any other kernel. For the
    backward also whether a second call gives the same bits."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    if name == 'grouped_conv':
        x, W, bias = args
        x2, b2 = x.reshape(-1, W.shape[0]), bias.to(x.dtype)
        return {'library_ms': time_ms(lambda: torch.addmm(b2, x2, W),
                                      reps=5, warmup=2)}
    if name != 'grouped_conv_bwd':
        return {}
    x, W, dout, _ = args
    x2, d2 = x.reshape(-1, W.shape[0]), dout.reshape(-1, W.shape[1])
    bwd = kernels.grouped_conv.grouped_conv_bwd
    first, again = bwd(*args), bwd(*args)
    torch.cuda.synchronize()
    return {'library_ms': time_ms(lambda: torch.mm(d2, W.t()), reps=5,
                                  warmup=2)
            + time_ms(lambda: torch.mm(x2.t(), d2), reps=5, warmup=2),
            'bitwise_repeat': all(torch.equal(a, b)
                                  for a, b in zip(first, again)
                                  if a is not None)}


def moments_library(name, args):
    """The one-call yardstick of a moments call, timed on its input x [b,
    rows, L]: torch.var_mean over the rows, the same bytes read for the
    same per-lane statistics; {} for any other kernel."""
    import torch
    if name != 'moments':
        return {}
    return {'library_ms': time_ms(
        lambda: torch.var_mean(args[0], dim=1, correction=0))}


# the kernels also timed by ``device_ms`` (``device_extras``): calls that
# take well under 50 us on the card, where ``time_ms`` times the wrapper's
# host work
DEVICE_TIMED = ('fps', 'ball_query', 'ones_conv', 'moments')


def device_extras(name, args):
    """For a call of fps, ball_query, the ones conv or moments: the
    wrapper's time by ``device_ms`` (``device_ms``) and, for moments, its
    yardstick torch.var_mean's (``library_ms_device``). {} for any other
    call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    if name not in DEVICE_TIMED:
        return {}
    fn = getattr({k.name: k for k in kernels.KERNELS}[name].module, name)
    rec = {'device_ms': device_ms(lambda: fn(*args))}
    if name == 'moments':
        rec['library_ms_device'] = device_ms(
            lambda: torch.var_mean(args[0], dim=1, correction=0))
    return rec


def sampling_extras(name, args, got):
    """For a call of fps or ball_query: the kernel it ran (``route``, from
    the wrapper's counts: fps 'reg' or 'smem', ball_query 'warp' or
    'thread') and whether a second call gives the same indices
    (``bitwise_repeat``). With --parent-csrc also the earlier tree's C
    entry (epn_fps, epn_ball_query) on the same inputs, timed by
    ``device_ms`` with this tree's in turns (parent, new, new, parent;
    ``parent_ms``, ``same_timer_ms``), and whether the two give the same
    indices (``parent_equal``). {} for any other call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    if name not in ('fps', 'ball_query'):
        return {}
    mod = getattr(kernels, name)
    before = dict(mod.routes)
    again = getattr(mod, name)(*args)
    torch.cuda.synchronize()
    route = next(k for k in mod.routes if mod.routes[k] > before[k])
    rec = {'route': route, 'bitwise_repeat': torch.equal(got, again)}
    if not PARENT or (name == 'ball_query' and args[4] and not getattr(
            PARENT[name], 'has_ref_fill', True)):
        # an earlier tree's ball query may predate the reference fill
        return rec
    if name == 'fps':
        x, n_sample, eps = args
        ins = (x.data_ptr(),)
        tail = (x.shape[0], x.shape[1], n_sample, float(eps))
        entry = {'reg': 'epn_fps_reg', 'smem': 'epn_fps'}[route]
    else:
        x, support, radius, n_sample, ref_fill = args
        ins = (x.data_ptr(), support.data_ptr())
        tail = (x.shape[0], x.shape[1], support.shape[1], n_sample,
                mod._r2_f32(radius), int(ref_fill))
        entry = {'warp': 'epn_ball_query_warp',
                 'thread': 'epn_ball_query'}[route]
    outs = (torch.empty_like(got), torch.empty_like(got))

    def call(fn, out):
        ptrs = ins + (out.data_ptr(),) + tail

        def run():
            err = fn(*ptrs, build.stream(x))
            if err:
                raise RuntimeError(f'{name}: CUDA error {err}')
        return run
    rec['parent_ms'], rec['same_timer_ms'] = time_abba(
        call(PARENT[name], outs[0]),
        call(getattr(build.library(), entry), outs[1]), device_ms)
    torch.cuda.synchronize()
    rec['parent_equal'] = torch.equal(outs[0], outs[1])
    return rec


def ones_conv_extras(name, args, got):
    """For a call of the ones conv: whether a second call gives the same
    bits (``bitwise_repeat``); in fp32 its normwise error and the plain fp32
    version's against the plain version in float64 (``rel_f64``,
    ``plain_rel_f64``) and their ratio (``f64_ratio``, gated <=
    ``f64_limit`` = 1.5). With --parent-csrc also the earlier tree's
    epn_ones_conv on the same inputs, timed by ``device_ms`` with this
    tree's in turns (parent, new, new, parent; ``parent_ms``,
    ``same_timer_ms``), and whether the two give the same bits
    (``parent_equal``: printed, not gated; the kernel's folded weight
    rounds otherwise). {} for any other call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    if name != 'ones_conv':
        return {}
    oc = kernels.ones_conv
    gx, rk, k2, sigma, dtype = args
    again = oc.ones_conv(*args)
    torch.cuda.synchronize()
    rec = {'bitwise_repeat': torch.equal(got, again)}
    del again
    if dtype == torch.float32:
        want = oc.ones_conv_plain(gx.double(), rk.double(), k2.double(),
                                  sigma, torch.float64)
        plain = oc.ones_conv_plain(*args)
        rec['rel_f64'] = float((got.double() - want).norm() / want.norm())
        rec['plain_rel_f64'] = float((plain.double() - want).norm()
                                     / want.norm())
        rec['f64_ratio'] = rec['rel_f64'] / max(rec['plain_rel_f64'], 1e-30)
        rec['f64_limit'] = 1.5
        del want, plain
    if PARENT:
        b, p2, nn, _ = gx.shape
        na, K = rk.shape[:2]
        outs = (torch.empty_like(got), torch.empty_like(got))

        def call(fn, out):
            ptrs = (gx.data_ptr(), rk.data_ptr(), k2.data_ptr(),
                    out.data_ptr(), b, p2, nn, na, K, float(sigma),
                    int(dtype == torch.bfloat16))

            def run():
                # the stream at the call: device_ms captures on its own
                err = fn(*ptrs, build.stream(gx))
                if err:
                    raise RuntimeError(f'ones_conv: CUDA error {err}')
            return run
        rec['parent_ms'], rec['same_timer_ms'] = time_abba(
            call(PARENT['ones_conv'], outs[0]),
            call(build.library().epn_ones_conv, outs[1]), device_ms)
        torch.cuda.synchronize()
        rec['parent_equal'] = torch.equal(outs[0], outs[1])
        del outs
    torch.cuda.empty_cache()
    return rec


def check_ones_calls(tag, calls, dtype):
    """Every ones conv call of ``calls`` (captured (name, args) of a step or
    forward in ``dtype``) against ``ones_conv_plain`` on its inputs (fp32
    normwise <= 1e-5, bf16 <= 4e-3), finite, with ``ones_conv_extras``'
    gates, and timed by ``device_ms``: its rows."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    oc = kernels.ones_conv
    rows = []
    with torch.no_grad():
        for name, args in calls:
            got, want = oc.ones_conv(*args), oc.ones_conv_plain(*args)
            torch.cuda.synchronize()
            tol = 1e-5 if dtype == 'fp32' else 4e-3
            row = {'shape': _shape_desc(name, args),
                   'rel_norm_err': rel_err(got, want),
                   'max_abs_err': float((got.float() - want.float()).abs()
                                        .max()),
                   'device_ms': device_ms(lambda: oc.ones_conv(*args)),
                   **ones_conv_extras(name, args, got)}
            row['ok'] = (row['rel_norm_err'] <= tol and _extras_ok(row)
                         and bool(torch.isfinite(got).all()))
            log(f'{tag} ones_conv L0 ({row["shape"]}): max_abs_err='
                f'{row["max_abs_err"]:.3e} rel_norm_err='
                f'{row["rel_norm_err"]:.3e} [rel_norm<={tol:.0e}]'
                f'{_library_note(row)} {"OK" if row["ok"] else "FAIL"}')
            rows.append(row)
            del got, want
    torch.cuda.empty_cache()
    assert rows and all(r['ok'] for r in rows), rows
    return rows


def mm_library(name, args):
    """The one-call yardstick of a dW reduction and of the fp32 intra
    forward and df: one torch.mm of its operand formed beforehand
    (untimed), on the call's inputs. The inter dW: F^T dout, F
    [M, 24c] the neighbor contraction (``inter_conv_f_plain``); the intra
    dW (plain and prenorm): A^T dout, A [M, 12c] the input (prenorm: folded
    and activated) gathered through the adjacency; the fp32 intra forward:
    A W; the fp32 intra df: the dout gathered through the inverse
    adjacency [M, 12d] by W^T [12d, c] (the dTable's is timed by
    ``inter_bwd_extras``). A bf16 product asks for an fp32 output, as the
    kernels' dW is. The W-off F: one batched torch.matmul over the (point,
    anchor) rows of the
    anchor weights [K, nn] (rounded to bf16 from a bf16 table, as the
    kernel rounds them) by the gathered table rows [nn, c], in the table's
    type, as the kernel stores F. {} for any other call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    if name == 'inter_conv_f':
        return _woff_f_library(*args)
    if name == 'intra_conv_df':
        dout, _, inv, W = args
        K, c, d = W.shape
        lhs = dout[:, :, inv.long()].reshape(-1, K * d)
        rhs = W.transpose(1, 2).reshape(K * d, c)
    elif name == 'inter_conv_dw':
        gx, idx, table, rk, k2, dout, sigma = args
        K, c = rk.shape[1], table.shape[3]
        lhs = kernels.inter_conv.inter_conv_f_plain(
            gx, idx, table, rk, k2, sigma).reshape(-1, K * c).t()
        rhs = dout.reshape(-1, dout.shape[-1])
    elif name in ('intra_conv_dw', 'intra_conv_prenorm_dw', 'intra_conv'):
        if name == 'intra_conv_prenorm_dw':
            f, ss, ti, last, slope = args
            f = kernels.intra_conv.prenorm_plain(f, ss, slope)
        else:
            f, ti, last = args
        K, c = ti.shape[1], f.shape[3]
        lhs = f[:, :, ti.long()].reshape(-1, K * c)
        if name == 'intra_conv':
            rhs = last.reshape(K * c, -1)
        else:
            lhs, rhs = lhs.t(), last.reshape(-1, last.shape[-1])
    else:
        return {}
    kw = {'out_dtype': torch.float32} if lhs.dtype == torch.bfloat16 else {}
    ms = time_ms(lambda: torch.mm(lhs, rhs, **kw), reps=5, warmup=2)
    del lhs, rhs
    torch.cuda.empty_cache()
    return {'library_ms': ms}


def _woff_f_library(gx, idx, table, rk, k2, sigma):
    """{'library_ms': one torch.matmul of the W-off F, w^T [M, K, nn] by G
    [M, nn, c] over the M = b * p2 * na (point, anchor) rows}, both operands
    formed beforehand (untimed) from the call's inputs."""
    import torch
    from epn_pointcloud_tpu_torch.ops.kernels import inter_conv
    b, _, na, c = table.shape
    K, nn = rk.shape[1], idx.shape[2]
    w = inter_conv.anchor_weights(gx, rk, k2, sigma).to(table.dtype)
    wt = w.permute(0, 1, 3, 4, 2).reshape(-1, K, nn)        # [M, K, nn]
    del w
    padded = torch.cat([table, table.new_zeros(b, 1, na, c)], dim=1)
    G = inter_conv._gather_chunk(padded, idx.long(), 0, na)  # [b,p2,nn,na,c]
    G = G.permute(0, 1, 3, 2, 4).reshape(-1, nn, c)
    del padded
    ms = time_ms(lambda: torch.matmul(wt, G), reps=5, warmup=2)
    del wt, G
    torch.cuda.empty_cache()
    return {'library_ms': ms}


def _library_note(row):
    note = ''
    if 'library_ms' in row:
        note += f' library_ms={row["library_ms"]:.4f}'
    for key in ('device_ms', 'library_ms_device'):
        if key in row:
            note += f' {key}={row[key]:.4f}'
    if 'bitwise_repeat' in row:
        note += f' bitwise_repeat={row["bitwise_repeat"]}'
    if 'parent_equal' in row:
        note += f' parent_equal={row["parent_equal"]}'
    if 'rel_vs_mma_plain' in row:
        note += f' rel_vs_mma_plain={row["rel_vs_mma_plain"]:.3e} [<=1e-3]'
    if 'rel_vs_f_plain' in row:
        note += f' rel_vs_f_plain={row["rel_vs_f_plain"]:.3e} [<=1e-3]'
    if 'bitwise_vs_template' in row:
        note += f' bitwise_vs_template={row["bitwise_vs_template"]}'
    if 'f64_ratio' in row:
        # the error it is held to: the template's (the SGEMM's), or the
        # plain version's in fp32
        ref = 'plain' if 'plain_rel_f64' in row else 'template'
        note += (f' rel_f64={row["rel_f64"]:.3e} {ref}_rel_f64='
                 f'{row[ref + "_rel_f64"]:.3e} [ratio <= '
                 f'{row.get("f64_limit", 2.0)}]')
    if 'refactor_ms' in row:
        note += (f' refactor_parent_ms={row["refactor_parent_ms"]:.4f} '
                 f'refactor_ms={row["refactor_ms"]:.4f} refactor_equal='
                 f'{row["refactor_equal"]}')
    for key in ('composed_peak_gib', 'kernel_peak_gib'):
        if key in row:
            note += f' {key}={row[key]:.3f}'
    for key in ('route', 'composed_ms', 'parent_ms', 'same_timer_ms'):
        if key in row:
            v = row[key]
            note += f' {key}={v:.4f}' if isinstance(v, float) else \
                f' {key}={v}'
    return note


# the kernels a row's ``route`` may name (``_extras_ok``): the redesigned
# ones, which every model layer at 60 anchors runs; below 60 anchors the
# fp32 inter forward, dTable and dW also run the templates (TEMPLATES)
REDESIGNED = ('mma', 'dtable_mma', 'dg_mma', 'dtable_f32', 'dg_f32', 'dw_mma',
              'dw_f32', 'f_mma', 'f_f32', 'fwd_f32', 'reg', 'warp')
TEMPLATES = ('sgemm', 'dtable', 'dw')


def _extras_ok(row, routes=REDESIGNED):
    """The own gates of an inter forward (``inter_conv_extras``), intra
    forward or B6 df (``intra_conv_extras``), backward scatter in either
    dtype (``inter_bwd_extras``), inter dW (``inter_dw_extras``), intra dW
    (``intra_dw_extras``) and W-off F (``inter_f_extras``): the tensor-core
    kernel ran (the fp32 inter forward, dW, scatter, W-off F and intra
    forward and df: their CUDA-core kernel; the inter dW at most twice the
    template's error against float64, the inter forward, intra dW, forward
    and df 1.5 times the template's or SGEMM's (``f64_limit``), the W-off F
    bitwise the template's), its output is bitwise equal on a second call
    (not the scatter's: atomics), within 1e-3 (normwise) of
    ``inter_conv_mma_plain`` (bf16 inter forward) or ``inter_conv_f_plain``
    (bf16 W-off F), and (--parent-csrc) the kernels whose F build now runs
    the shared add_neighbor step (the fp32 template forward, dW and W-off
    F) bitwise equal to the earlier tree's (``refactor_equal``).
    ``parent_equal`` is printed, not gated: a later tree may sum in another
    order. ``routes``: the kernels a row may have run (REDESIGNED)."""
    return (row.get('route', 'mma') in routes
            and row.get('bitwise_repeat', True)
            and row.get('bitwise_vs_template', True)
            and row.get('rel_vs_mma_plain', 0.0) <= 1e-3
            and row.get('rel_vs_f_plain', 0.0) <= 1e-3
            and row.get('f64_ratio', 0.0) <= row.get('f64_limit', 2.0)
            and row.get('refactor_equal', True))


# the earlier tree's kernels (--parent-csrc), timed beside this tree's:
# 'fn' its epn_inter_conv_mma, 'f' its epn_inter_conv_f, 'fwd' its
# epn_inter_conv (the SGEMM template), 'f_f32' its epn_inter_conv_f_f32,
# 'dw_f32' its epn_inter_conv_bwd_w_f32, 'intra_fwd' its
# epn_intra_conv, 'intra_df' its epn_intra_conv_prenorm_df, 'dtable' its
# epn_inter_conv_bwd_table, 'dg' its epn_inter_conv_dg, 'dw' its
# epn_inter_conv_bwd_w, 'intra_dw' its epn_intra_conv_bwd_w, 'fps' its
# epn_fps, 'ball_query' its epn_ball_query
PARENT = {}


def inter_f_extras(name, args, got):
    """For a call of the W-off F: the kernel it ran (``route``, from the
    wrapper's counts: 'f_mma' for the bf16 tensor-core kernel, 'f_f32' for
    the fp32 CUDA-core one) and whether a second call gives the same bits
    (``bitwise_repeat``); in bf16 its normwise error against
    ``inter_conv_f_plain`` (the plain version at the TPU kernel's rounding
    points: ``rel_vs_f_plain``), in fp32 whether it equals this tree's
    template (epn_inter_conv_f with bf16 = 0) on the same inputs bit for
    bit (``bitwise_vs_template``). With --parent-csrc also the earlier
    tree's epn_inter_conv_f (in the call's dtype) on the same inputs, timed
    with this tree's C entry in turns (parent, new, new, parent; both into
    one preallocated F; ``parent_ms``, ``same_timer_ms``), and in fp32 the
    earlier tree's epn_inter_conv_f_f32 with this tree's
    (``_same_kernel``). {} for any other call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    if name != 'inter_conv_f':
        return {}
    ic = kernels.inter_conv
    bf16 = args[2].dtype == torch.bfloat16
    before = dict(ic.routes)
    again = ic.inter_conv_f(*args)
    torch.cuda.synchronize()
    rec = {'route': next(k for k in ic.routes if ic.routes[k] > before[k]),
           'bitwise_repeat': torch.equal(got, again)}
    del again
    gx, idx, table, rk, k2, sigma = args
    b, p2, nn = idx.shape
    q, na, c = table.shape[1:]
    K = rk.shape[1]
    F = torch.empty_like(got)
    ptrs = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(), rk.data_ptr(),
            k2.data_ptr(), F.data_ptr(), b, p2, nn, q, na, K, c, float(sigma))

    def call(fn, tail):
        def run():
            err = fn(*ptrs, *tail, build.stream(gx))
            if err:
                raise RuntimeError(f'{name}: CUDA error {err}')
        return run
    lib = build.library()
    if bf16:
        rec['rel_vs_f_plain'] = rel_err(got, ic.inter_conv_f_plain(*args))
    else:
        call(lib.epn_inter_conv_f, (0,))()
        torch.cuda.synchronize()
        rec['bitwise_vs_template'] = torch.equal(got, F)
    if PARENT:
        rec['parent_ms'], rec['same_timer_ms'] = time_abba(
            call(PARENT['f'], (int(bf16),)),
            call(lib.epn_inter_conv_f_mma if bf16 else
                 lib.epn_inter_conv_f_f32, ()))
    if PARENT and not bf16:
        rec.update(_same_kernel(call(PARENT['f_f32'], ()),
                                call(lib.epn_inter_conv_f_f32, ()), F))
    del F
    torch.cuda.empty_cache()
    return rec


def inter_dw_extras(name, args, got):
    """For a call of the fused inter dW: the kernel it ran (``route``, from
    the wrapper's counts: 'dw_mma' for the bf16 tensor-core kernel,
    'dw_f32' for the fp32 CUDA-core one) and whether a second call gives
    the same bits (``bitwise_repeat``). In fp32 also its normwise error and
    the template's (this tree's epn_inter_conv_bwd_w, the route before it,
    on the same inputs) against ``inter_conv_dw_plain`` in float64
    (``rel_f64``, ``template_rel_f64``) and their ratio (``f64_ratio``,
    gated <= 2). With --parent-csrc also the earlier tree's
    epn_inter_conv_bwd_w (in the call's dtype) on the same inputs, timed
    with this tree's C entry in turns (parent, new, new, parent; each with
    its own workspace, into one preallocated dW; ``parent_ms``,
    ``same_timer_ms``), and in fp32 the earlier tree's
    epn_inter_conv_bwd_w_f32 with this tree's (``_same_kernel``); off the
    redesigned kernels' 60 anchors, this tree's template (the route the
    call ran). {} for any other call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    if name != 'inter_conv_dw':
        return {}
    ic = kernels.inter_conv
    bf16 = args[2].dtype == torch.bfloat16
    before = dict(ic.routes)
    again = ic.inter_conv_dw(*args)
    torch.cuda.synchronize()
    rec = {'route': next(k for k in ic.routes if ic.routes[k] > before[k]),
           'bitwise_repeat': torch.equal(got, again)}
    del again
    gx, idx, table, rk, k2, dout, sigma = args
    b, p2, nn = idx.shape
    q, na, c = table.shape[1:]
    K, d = rk.shape[1], dout.shape[-1]
    M = b * p2 * na
    dW = torch.empty_like(got)
    keep = []

    def call(fn, route, tail):
        splits = ic.dw_splits(M, c, d, route)
        ws = torch.empty((splits, K, c, d), dtype=torch.float32,
                         device=got.device)
        keep.append(ws)
        ptrs = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(),
                rk.data_ptr(), k2.data_ptr(), dout.data_ptr(), ws.data_ptr(),
                dW.data_ptr(), b, p2, nn, q, na, K, c, d, float(sigma),
                splits) + tail

        def run():
            err = fn(*ptrs, build.stream(gx))
            if err:
                raise RuntimeError(f'{name}: CUDA error {err}')
        return run
    lib = build.library()
    if not bf16:
        want = ic.inter_conv_dw_plain(gx.double(), idx, table.double(),
                                      rk.double(), k2.double(),
                                      dout.double(), sigma)
        call(lib.epn_inter_conv_bwd_w, 'dw', (0,))()
        torch.cuda.synchronize()
        rec['rel_f64'] = float((got.double() - want).norm() / want.norm())
        rec['template_rel_f64'] = float((dW.double() - want).norm()
                                        / want.norm())
        rec['f64_ratio'] = rec['rel_f64'] / max(rec['template_rel_f64'],
                                                1e-30)
        del want
    if PARENT:
        new = {'dw_mma': (lib.epn_inter_conv_bwd_w_mma, ()),
               'dw_f32': (lib.epn_inter_conv_bwd_w_f32,
                          (ic.dw_f32_cols(d),)),
               'dw': (lib.epn_inter_conv_bwd_w, (int(bf16),))}[rec['route']]
        rec['parent_ms'], rec['same_timer_ms'] = time_abba(
            call(PARENT['dw'], 'dw', (int(bf16),)),
            call(new[0], rec['route'], new[1]))
    if PARENT and rec['route'] == 'dw_f32':
        tail = (ic.dw_f32_cols(d),)
        rec.update(_same_kernel(call(PARENT['dw_f32'], 'dw_f32', tail),
                                call(lib.epn_inter_conv_bwd_w_f32, 'dw_f32',
                                     tail), dW))
    del dW, keep
    torch.cuda.empty_cache()
    return rec


def check_fp32_rows(tag, rows, n_expect, what='fused dW',
                    mm='torch.mm(F^T, dout)', limit=2.0, route='dw_f32',
                    tol=1e-4, yard='library_ms'):
    """Every fp32 call of a CUDA-core kernel in a phase (``rows``: phase
    2's, 6's or 12's; the fused inter dW, or ``what`` = 'intra dW', 'intra
    forward', 'intra df', 'inter forward') on its kernel (``route``),
    bitwise equal on a second call, within ``tol`` of its plain version and
    at most ``limit`` times the error of the template (the SGEMM) against
    float64; the sums printed beside the template's under one timer
    (--parent-csrc), the yardstick ``mm`` (the rows' ``yard``: one torch.mm,
    or the inter forward's composition) and, where the template's F build
    now runs the shared step, the earlier source's same kernel under one
    timer."""
    routes = [r['route'] for r in rows]
    ratios = [r['f64_ratio'] for r in rows]
    agg = _aggregate(rows)

    def col(key):
        return ' '.join(f'{r[key]:.2e}' for r in rows)
    log(f'{tag} fp32 {what}: {len(rows)} calls, routes {routes}; '
        f'rel_norm_err vs plain {col("rel_norm_err")} (<= {tol:.0e}); vs '
        f'float64 {col("rel_f64")}, the template {col("template_rel_f64")}'
        f', ratio max {max(ratios):.3f} (<= {limit}); bitwise '
        f'{all(r["bitwise_repeat"] for r in rows)}; kernel {agg["ms"]:.3f} '
        f'ms, {mm} {agg[yard]:.3f}, bound '
        f'{agg["bound_ms"]:.3f} (share {agg["bound_ms"] / agg["ms"]:.3f})'
        + (f', one timer: parent template {agg["parent_ms"]:.3f} vs '
           f'{agg["same_timer_ms"]:.3f}' if 'parent_ms' in agg else '')
        + (f'; the same kernel, earlier source vs this one: '
           f'{agg["refactor_parent_ms"]:.3f} vs {agg["refactor_ms"]:.3f} '
           f'({agg["refactor_ms"] / agg["refactor_parent_ms"] - 1:+.2%}), '
           f'bitwise {all(r["refactor_equal"] for r in rows)}'
           if 'refactor_ms' in agg else ''))
    assert len(rows) == n_expect and set(routes) == {route}, routes
    assert all(r['bitwise_repeat'] for r in rows)
    assert max(r['rel_norm_err'] for r in rows) <= tol
    assert max(ratios) <= limit, ratios


def intra_dw_extras(name, args, got):
    """For a call of the intra dW (B6 dW, or the plain form's): the kernel
    it ran (``route``, from the wrapper's counts: 'dw_mma' for the bf16
    tensor-core kernel, 'dw_f32' for the fp32 CUDA-core one) and whether a
    second call gives the same bits (``bitwise_repeat``). In fp32 also its
    normwise error and the SGEMM's (this tree's epn_intra_conv_bwd_w, the
    route before it, on the same inputs) against ``intra_conv_dw_plain``
    in float64 (``rel_f64``, ``template_rel_f64``) and their ratio
    (``f64_ratio``, gated <= ``f64_limit`` = 1.5). With --parent-csrc also
    the earlier tree's epn_intra_conv_bwd_w (in the call's dtype) on the
    same inputs, timed with this tree's C entry in turns (parent, new, new,
    parent; each with its own workspace and splits, into one preallocated
    dW; ``parent_ms``, ``same_timer_ms``). {} for any other call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    if name not in ('intra_conv_dw', 'intra_conv_prenorm_dw'):
        return {}
    ik = kernels.intra_conv
    bf16 = args[0].dtype == torch.bfloat16
    before = dict(ik.routes)
    again = getattr(ik, name)(*args)
    torch.cuda.synchronize()
    rec = {'route': next(k for k in ik.routes if ik.routes[k] > before[k]),
           'bitwise_repeat': torch.equal(got, again)}
    del again
    if name == 'intra_conv_prenorm_dw':
        f, ss, ti, dout, slope = args
    else:
        (f, ti, dout), ss, slope = args, None, build.LEAKY_SLOPE
    b, p, na, c = f.shape
    K, d = ti.shape[1], dout.shape[-1]
    dW = torch.empty_like(got)
    keep = []

    def call(fn, route):
        splits, rows = (ik.dw_f32_splits(b * p, na, c, d) if route == 'dw_f32'
                        else ik.dw_splits(b * p, na, K, c, d,
                                          route == 'dw_mma'))
        ws = torch.empty((splits, K, c, d), dtype=torch.float32,
                         device=got.device)
        keep.append(ws)
        ptrs = (f.data_ptr(), ti.data_ptr(),
                0 if ss is None else ss.data_ptr(), dout.data_ptr(),
                ws.data_ptr(), dW.data_ptr(), b, p, na, K, c, d,
                2 * na * c if ss is not None and ss.shape[0] > 1 else 0) + (
                    (slope, splits, int(bf16)) if route == 'dw'
                    else (slope, splits, rows) if route == 'dw_mma'
                    else (splits, rows))

        def run():
            err = fn(*ptrs, build.stream(f))
            if err:
                raise RuntimeError(f'{name}: CUDA error {err}')
        return run
    lib = build.library()
    if rec['route'] == 'dw_f32':
        want = ik.intra_conv_dw_plain(f.double(), ti, dout.double())
        call(lib.epn_intra_conv_bwd_w, 'dw')()
        torch.cuda.synchronize()
        rec['rel_f64'] = float((got.double() - want).norm() / want.norm())
        rec['template_rel_f64'] = float((dW.double() - want).norm()
                                        / want.norm())
        rec['f64_ratio'] = rec['rel_f64'] / max(rec['template_rel_f64'],
                                                1e-30)
        rec['f64_limit'] = 1.5
        del want
    if PARENT and rec['route'] in ('dw_mma', 'dw_f32'):
        rec['parent_ms'], rec['same_timer_ms'] = time_abba(
            call(PARENT['intra_dw'], 'dw'),
            call(getattr(lib, 'epn_intra_conv_bwd_w_mma' if bf16 else
                         'epn_intra_conv_bwd_w_f32'), rec['route']))
    del dW, keep
    torch.cuda.empty_cache()
    return rec


def inter_bwd_extras(name, args, got):
    """For a call of the backward scatter (the fused dTable or the W-off
    dG): the kernel it ran (``route``, from the wrapper's counts:
    'dtable_mma' / 'dg_mma' for the bf16 tensor-core kernel, 'dtable_f32'
    / 'dg_f32' for the fp32 CUDA-core one). For the dTable also its
    library yardstick, one ``torch.mm(dout2, W2^T)`` (the dF product it
    fuses; ``library_ms``), and the composition it replaces, that torch.mm
    then the dG kernel of the call's dtype on its output (``composed_ms``).
    With --parent-csrc also the earlier tree's C entry (in the call's
    dtype) on the same inputs, timed with this tree's in turns (parent,
    new, new, parent; both into one preallocated dT; ``parent_ms``,
    ``same_timer_ms``). Off the redesigned kernels' 60 anchors the
    composition's dG and this tree's entry are the template's (the route
    the call ran). {} for any other call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    if name not in ('inter_conv_dtable', 'inter_conv_dg'):
        return {}
    ic = kernels.inter_conv
    before = dict(ic.routes)
    getattr(ic, name)(*args)
    torch.cuda.synchronize()
    rec = {'route': next(k for k in ic.routes if ic.routes[k] > before[k])}
    gx, idx, q, rk, k2 = args[:5]
    b, p2, nn = idx.shape
    na, K = rk.shape[:2]
    c = got.shape[-1]
    bf16 = args[5].dtype == torch.bfloat16
    head = (gx.data_ptr(), idx.data_ptr(), rk.data_ptr(), k2.data_ptr())
    dT = torch.zeros_like(got)
    lib = build.library()
    template = rec['route'] in ('dtable', 'dg')
    kind = 'mma' if bf16 else 'f32'
    dg_entry, dg_tail = (('epn_inter_conv_dg', (int(bf16),)) if template else
                         (f'epn_inter_conv_dg_{kind}', ()))
    tail = (int(bf16),) if template else ()
    if name == 'inter_conv_dtable':
        W, dout = args[5], args[6]
        d = W.shape[2]
        dout2, W2 = dout.reshape(-1, d), W.reshape(K * c, d)
        rec['library_ms'] = time_ms(lambda: torch.mm(dout2, W2.t()), reps=5,
                                    warmup=2)

        def composed():
            dF = torch.mm(dout2, W2.t())
            build.launch(dg_entry, *head, dF.data_ptr(), dT.data_ptr(), b,
                         p2, nn, q, na, K, c, float(args[7]), *dg_tail,
                         build.stream(dout))
        rec['composed_ms'] = time_ms(composed, reps=5, warmup=2)
        ptrs = head + (W.data_ptr(), dout.data_ptr(), dT.data_ptr(), b, p2,
                       nn, q, na, K, c, d, float(args[7]))
        pair = ('dtable', 'epn_inter_conv_bwd_table' if template else
                f'epn_inter_conv_bwd_table_{kind}')
        if not bf16 and not template:
            ws = torch.empty(ic.bwd_f32_workspace(b, p2, K, c, d),
                             dtype=torch.float32, device=got.device)
            tail = (ws.data_ptr(),)
    else:
        ptrs = head + (args[5].data_ptr(), dT.data_ptr(), b, p2, nn, q, na,
                       K, c, float(args[6]))
        pair = ('dg', dg_entry)
    if PARENT:
        def call(fn, tail):
            def run():
                err = fn(*ptrs, *tail, build.stream(gx))
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            return run
        rec['parent_ms'], rec['same_timer_ms'] = time_abba(
            call(PARENT[pair[0]], (int(bf16),)),
            call(getattr(lib, pair[1]), tail))
    del dT
    torch.cuda.empty_cache()
    return rec


def inter_fwd_f32_gate(args, got):
    """For an fp32 call of the W-fused inter forward: the kernel it ran
    (``route``: 'fwd_f32', the CUDA-core kernel), whether a second call
    gives the same bits (``bitwise_repeat``), its normwise error and the
    template's (this tree's epn_inter_conv, bf16 = 0, the route before it,
    on the same inputs) against ``inter_conv_plain`` in float64
    (``rel_f64``, ``template_rel_f64``) and their ratio (``f64_ratio``,
    gated <= ``f64_limit`` = 1.5)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    ic = kernels.inter_conv
    before = dict(ic.routes)
    again = ic.inter_conv(*args)
    torch.cuda.synchronize()
    rec = {'route': next(k for k in ic.routes if ic.routes[k] > before[k]),
           'bitwise_repeat': torch.equal(got, again)}
    del again
    gx, idx, table, rk, k2, W, sigma = args
    b, p2, nn = idx.shape
    q, na, c = table.shape[1:]
    K, _, d = W.shape
    tmpl = torch.empty_like(got)
    err = build.library().epn_inter_conv(
        gx.data_ptr(), idx.data_ptr(), table.data_ptr(), rk.data_ptr(),
        k2.data_ptr(), W.data_ptr(), tmpl.data_ptr(), b, p2, nn, q, na, K, c,
        d, float(sigma), 0, build.stream(gx))
    if err:
        raise RuntimeError(f'epn_inter_conv: CUDA error {err}')
    want = ic.inter_conv_plain(gx.double(), idx, table.double(), rk.double(),
                               k2.double(), W.double(), sigma)
    torch.cuda.synchronize()
    rec['rel_f64'] = float((got.double() - want).norm() / want.norm())
    rec['template_rel_f64'] = float((tmpl.double() - want).norm()
                                    / want.norm())
    rec['f64_ratio'] = rec['rel_f64'] / max(rec['template_rel_f64'], 1e-30)
    rec['f64_limit'] = 1.5
    del want, tmpl
    torch.cuda.empty_cache()
    return rec


def _extra_gib(fn):
    """GiB of device memory ``fn()`` allocates beyond what is allocated
    before it (its peak; what it returns is freed after)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 2 ** 30


def _same_kernel(old, new, out):
    """(--parent-csrc) One kernel built from the earlier source (``old``,
    before its F build ran the shared add_neighbor step) and from this one
    (``new``), both writing ``out``: timed in turns (``refactor_parent_ms``,
    ``refactor_ms``) and compared bit for bit (``refactor_equal``)."""
    import torch
    rec = dict(zip(('refactor_parent_ms', 'refactor_ms'),
                   time_abba(old, new)))
    old()
    torch.cuda.synchronize()
    want = out.clone()
    new()
    torch.cuda.synchronize()
    rec['refactor_equal'] = torch.equal(out, want)
    return rec


def inter_fwd_f32_times(args, got):
    """The fp32 W-fused inter forward beside its yardstick and, with
    --parent-csrc, the earlier tree's kernels, on the call's inputs: the
    composition (F [M, 24c] by the W-off F kernel, epn_inter_conv_f_f32,
    then one torch.mm(F, W) in fp32; ``composed_ms``; no one PyTorch call
    computes the function) and the device memory beyond the inputs that
    one composed call and one kernel call need (``composed_peak_gib``,
    ``kernel_peak_gib``); the earlier tree's template (epn_inter_conv,
    bf16 = 0) timed with this tree's epn_inter_conv_fwd_f32 in turns
    (parent, new, new, parent; ``parent_ms``, ``same_timer_ms``) and with
    this tree's template (``_same_kernel``). Off the 60 anchors of the
    CUDA-core kernels, the composition's F is the template's W-off mode
    (epn_inter_conv_f, bf16 = 0), and the earlier template is timed against
    this tree's, the route the call ran."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    ic = kernels.inter_conv
    gx, idx, table, rk, k2, W, sigma = args
    b, p2, nn = idx.shape
    q, na, c = table.shape[1:]
    K, _, d = W.shape
    lib = build.library()
    head = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(), rk.data_ptr(),
            k2.data_ptr())
    dims = (b, p2, nn, q, na, K, c)
    W2 = W.reshape(K * c, d)
    f_f32 = ic.f_f32_route(table.dtype, K, c, nn, na)
    f_entry, f_tail = ((lib.epn_inter_conv_f_f32, ()) if f_f32 else
                       (lib.epn_inter_conv_f, (0,)))

    def composed(F):
        err = f_entry(*head, F.data_ptr(), *dims, float(sigma), *f_tail,
                      build.stream(gx))
        if err:
            raise RuntimeError(f'inter W-off F: CUDA error {err}')
        return torch.mm(F, W2)

    def composed_fresh():
        return composed(torch.empty(b * p2 * na, K * c, device=gx.device))
    rec = {'composed_peak_gib': _extra_gib(composed_fresh),
           'kernel_peak_gib': _extra_gib(lambda: ic.inter_conv(*args))}
    F = torch.empty(b * p2 * na, K * c, device=gx.device)
    rec['composed_ms'] = time_ms(lambda: composed(F), reps=5, warmup=2)
    del F
    torch.cuda.empty_cache()
    if PARENT:
        out = torch.empty_like(got)

        def call(fn, tail):
            def run():
                err = fn(*head, W.data_ptr(), out.data_ptr(), *dims, d,
                         float(sigma), *tail, build.stream(gx))
                if err:
                    raise RuntimeError(f'inter forward: CUDA error {err}')
            return run
        parent = call(PARENT['fwd'], (0,))
        fwd_f32 = ic.fwd_f32_route(table.dtype, K, c, d, nn, na)
        rec['parent_ms'], rec['same_timer_ms'] = time_abba(
            parent, call(lib.epn_inter_conv_fwd_f32, ()) if fwd_f32 else
            call(lib.epn_inter_conv, (0,)))
        rec.update(_same_kernel(parent, call(lib.epn_inter_conv, (0,)), out))
        del out
        torch.cuda.empty_cache()
    return rec


def inter_conv_extras(name, args, got):
    """For an fp32 call of the W-fused inter forward, its gate
    (``inter_fwd_f32_gate``) and times (``inter_fwd_f32_times``).
    For a bf16 call of the W-fused inter forward: the kernel it ran
    (``route``, from the wrapper's counts: 'mma' for the tensor-core
    kernel), whether a second call gives the same bits, its normwise error
    against ``inter_conv_mma_plain`` (the plain version at the kernel's
    rounding points, the TPU kernel's: ``rel_vs_mma_plain``), and the time
    of the composition that the fused kernel spares (the W-off F kernel of
    the bf16 route, F stored, then one ``torch.mm(F, W)``;
    ``composed_ms``). With
    --parent-csrc also the earlier tree's kernel on the same inputs, timed
    with this one in turns (parent, new, new, parent; ``parent_ms``,
    ``same_timer_ms``), and whether its output has the same bits as this
    one's (``parent_equal``), where the call ran the tensor-core kernel.
    {} for any other call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    if name != 'inter_conv':
        return {}
    if args[2].dtype == torch.float32:
        return {**inter_fwd_f32_gate(args, got),
                **inter_fwd_f32_times(args, got)}
    ic = kernels.inter_conv
    before = dict(ic.routes)
    again = ic.inter_conv(*args)
    torch.cuda.synchronize()
    rec = {'route': next(k for k in ic.routes if ic.routes[k] > before[k]),
           'bitwise_repeat': torch.equal(got, again),
           'rel_vs_mma_plain': rel_err(got, ic.inter_conv_mma_plain(*args))}
    del again
    gx, idx, table, rk, k2, W, sigma = args
    b, p2, nn = idx.shape
    q, na, c = table.shape[1:]
    K, _, d = W.shape
    ptrs = (gx.data_ptr(), idx.data_ptr(), table.data_ptr(), rk.data_ptr(),
            k2.data_ptr())
    F = torch.empty(b * p2 * na, K * c, dtype=table.dtype, device=gx.device)
    W2 = W.reshape(K * c, d)

    f_args = (F.data_ptr(), b, p2, nn, q, na, K, c, float(sigma))
    f_entry, f_tail = (('epn_inter_conv_f_mma', ())
                       if ic.f_mma_route(table.dtype, K, c, nn, na) else
                       ('epn_inter_conv_f', (1,)))

    def composed():
        build.launch(f_entry, *ptrs, *f_args, *f_tail, build.stream(table))
        torch.mm(F, W2)
    rec['composed_ms'] = time_ms(composed, reps=5, warmup=2)
    del F
    if PARENT and rec['route'] == 'mma':
        out = torch.empty_like(got)

        def parent():
            err = PARENT['fn'](*ptrs, W.data_ptr(), out.data_ptr(), b, p2, nn,
                               q, na, K, c, d, float(sigma),
                               build.stream(table))
            if err:
                raise RuntimeError(f'parent epn_inter_conv_mma: CUDA error '
                                   f'{err}')
        rec['parent_ms'], rec['same_timer_ms'] = time_abba(
            parent, lambda: ic.inter_conv(*args))
        torch.cuda.synchronize()
        rec['parent_equal'] = torch.equal(out, got)
    torch.cuda.empty_cache()
    return rec


def _intra_composition(name, args):
    """(A, W2, compose) of the library yardstick of a bf16 intra forward or
    B6 df: the gathered operand A [M, 12C] (z = the fold and activation of f
    gathered through trace_idx; df: dout gathered through inv_idx), W as
    [12C, D] (df: W transposed), and the whole composition (fold, gather,
    one torch.mm) as a function."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    ik = kernels.intra_conv
    if name == 'intra_conv_prenorm':
        f, ss, ti, W, slope = args
        K, c, d = W.shape
        W2 = W.reshape(K * c, d)

        def gather():
            return ik.prenorm_plain(f, ss, slope)[:, :, ti.long()].reshape(
                -1, K * c)
    else:
        dout, _, _, _, inv, W, _ = args
        K, c, d = W.shape
        W2 = W.transpose(1, 2).reshape(K * d, c)

        def gather():
            return dout[:, :, inv.long()].reshape(-1, K * d)
    return gather(), W2, lambda: torch.mm(gather(), W2)


def _intra_fwd_operands(name, args):
    """(g, adjacency, W [K, c, d]) of an fp32 intra forward or df call as
    the forward kernel takes them: (f, trace_idx, W), or for the df (dout,
    inv_idx, W^T)."""
    if name == 'intra_conv':
        return args
    dout, _, inv, W = args
    return dout, inv, W.transpose(1, 2).contiguous()


def intra_f32_extras(name, args, got):
    """For an fp32 call of the intra forward or df: the kernel it ran
    (``route``: 'fwd_f32', the CUDA-core kernel), whether a second call
    gives the same bits (``bitwise_repeat``), its normwise error and the
    SGEMM's (this tree's epn_intra_conv, bf16 = 0, the route before it, on
    the same inputs) against the plain version in float64 (``rel_f64``,
    ``template_rel_f64``) and their ratio (``f64_ratio``, gated <=
    ``f64_limit`` = 1.5). With --parent-csrc also the earlier tree's
    epn_intra_conv (fp32) timed with this tree's epn_intra_conv_f32 in
    turns (``_intra_parent_pair``; ``parent_ms``, ``same_timer_ms``)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    ik = kernels.intra_conv
    before = dict(ik.routes)
    again = getattr(ik, name)(*args)
    torch.cuda.synchronize()
    rec = {'route': next(k for k in ik.routes if ik.routes[k] > before[k]),
           'bitwise_repeat': torch.equal(got, again)}
    del again
    g, ti, W = _intra_fwd_operands(name, args)
    b, p, na, c = g.shape
    K, d = W.shape[0], W.shape[2]
    out = torch.empty_like(got)
    err = build.library().epn_intra_conv(
        g.data_ptr(), ti.data_ptr(), W.data_ptr(), 0, out.data_ptr(), b, p,
        na, K, c, d, 0, build.LEAKY_SLOPE, 0, build.stream(g))
    if err:
        raise RuntimeError(f'{name}: epn_intra_conv: CUDA error {err}')
    want = ik.intra_conv_plain(g.double(), ti, W.double())
    torch.cuda.synchronize()
    rec['rel_f64'] = float((got.double() - want).norm() / want.norm())
    rec['template_rel_f64'] = float((out.double() - want).norm()
                                    / want.norm())
    rec['f64_ratio'] = rec['rel_f64'] / max(rec['template_rel_f64'], 1e-30)
    rec['f64_limit'] = 1.5
    del want, out, W
    if PARENT:
        rec['parent_ms'], rec['same_timer_ms'] = time_abba(
            *_intra_parent_pair(name, args))
    torch.cuda.empty_cache()
    return rec


def intra_conv_extras(name, args, got):
    """For a bf16 call of the prenorm intra forward or of B6 df: the kernel
    it ran (``route``, from the wrapper's counts), whether a second call
    gives the same bits, and its library yardstick on the same inputs: one
    torch.mm of the gathered operand by W as [12C, D] (``library_ms``; the
    operand gathered beforehand, untimed: the gather is no part of the
    product's row) and the whole composition, fold and gather included
    (``composed_ms``; df's epilogue not included in either). With
    --parent-csrc also the earlier tree's kernel on the same inputs, its C
    entry timed with this tree's in turns (parent, new, new, parent;
    ``parent_ms``, ``same_timer_ms``). For an fp32 call of the intra
    forward or df, ``intra_f32_extras`` (its yardstick, one torch.mm, from
    ``mm_library``). {} for any other call."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    got = got if isinstance(got, tuple) else (got,)
    if name in ('intra_conv', 'intra_conv_df') and \
            got[0].dtype == torch.float32:
        return intra_f32_extras(name, args, got[0])
    if name not in ('intra_conv_prenorm', 'intra_conv_prenorm_df'):
        return {}
    if got[0].dtype != torch.bfloat16:
        return {}
    ik = kernels.intra_conv
    before = dict(ik.routes)
    again = getattr(ik, name)(*args)
    again = again if isinstance(again, tuple) else (again,)
    torch.cuda.synchronize()
    rec = {'route': next(k for k in ik.routes if ik.routes[k] > before[k]),
           'bitwise_repeat': all(torch.equal(a, b)
                                 for a, b in zip(got, again))}
    del again
    A, W2, compose = _intra_composition(name, args)
    rec['library_ms'] = time_ms(lambda: torch.mm(A, W2), reps=5, warmup=2)
    del A
    rec['composed_ms'] = time_ms(compose, reps=5, warmup=2)
    if PARENT:
        rec['parent_ms'], rec['same_timer_ms'] = time_abba(
            *_intra_parent_pair(name, args))
    torch.cuda.empty_cache()
    return rec


def _intra_parent_pair(name, args):
    """(the earlier tree's C entry, this tree's) on the same inputs and
    fresh outputs, each a function of no arguments that raises on a launch
    error."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    from epn_pointcloud_tpu_torch.ops.kernels import build
    ik = kernels.intra_conv
    if name in ('intra_conv', 'intra_conv_df'):
        # fp32: the forward, or the df as the forward on (dout, inv_idx,
        # W^T): the earlier tree's SGEMM (bf16 = 0) and this tree's kernel
        g, ti, W = _intra_fwd_operands(name, args)
        b, p, na, c = g.shape
        K, d = W.shape[0], W.shape[2]
        out = torch.empty((b, p, na, d), dtype=g.dtype, device=g.device)
        head = (g.data_ptr(), ti.data_ptr(), W.data_ptr(), 0, out.data_ptr(),
                b, p, na, K, c, d, 0)
        entries = (('intra_fwd', head + (build.LEAKY_SLOPE, 0)),
                   ('epn_intra_conv_f32', head))
        keep = (W, out)
    elif name == 'intra_conv_prenorm':
        f, ss, ti, W, slope = args
        b, p, na, c = f.shape
        K, d = W.shape[0], W.shape[2]
        out = torch.empty((b, p, na, d), dtype=f.dtype, device=f.device)
        head = (f.data_ptr(), ti.data_ptr(), W.data_ptr(), ss.data_ptr(),
                out.data_ptr(), b, p, na, K, c, d,
                2 * na * c if ss.shape[0] > 1 else 0)
        entries = (('intra_fwd', head + (slope, 1)),
                   ('epn_intra_conv_mma', head + (slope,)))
        keep = (out,)
    else:
        dout, f, ss, ti, inv, W, slope = args
        b, p, na, c = f.shape
        K, d = W.shape[0], W.shape[2]
        Wt = W.transpose(1, 2).contiguous()
        df = torch.empty_like(f)
        dss = torch.empty((2, ss.shape[0], na * c), dtype=torch.float32,
                          device=f.device)
        # the workspaces of the two kernels' blocks (2 or 512 / BN points)
        keep = (Wt, df, dss) + tuple(
            torch.empty((2, -(-p // n), b, na * c), dtype=torch.float32,
                        device=f.device)
            for n in (ik._DF_BLOCK_ROWS // na, ik.mma_block_points(c)))
        heads = [(dout.data_ptr(), inv.data_ptr(), Wt.data_ptr(),
                  f.data_ptr(), ss.data_ptr(), df.data_ptr(), ws.data_ptr(),
                  dss[0].data_ptr(), dss[1].data_ptr(), b, p, na, K, d, c,
                  ss.shape[0], slope) for ws in keep[3:]]
        entries = (('intra_df', heads[0] + (1,)),
                   ('epn_intra_conv_prenorm_df_mma', heads[1]))

    def call(fn, ptrs):
        def run(keep=keep):             # the outputs live with the closure
            err = fn(*ptrs, build.stream(args[0]))
            if err:
                raise RuntimeError(f'{name}: CUDA error {err}')
        return run
    (pname, pptrs), (nname, nptrs) = entries
    return (call(PARENT[pname], pptrs),
            call(getattr(build.library(), nname), nptrs))


def _kernel_pair(name, args):
    """(kernel wrapper, plain version, the plain's arguments) of a captured
    call of kernel ``name``. The intra df runs the forward kernel on the
    inverse adjacency; its plain version is the scatter, rounded once to
    dout's type as the kernel stores df."""
    from epn_pointcloud_tpu_torch.ops import kernels
    if name == 'intra_conv_df':
        ik = kernels.intra_conv

        def plain(dout, ti, W):
            return ik.intra_conv_df_plain(dout, ti, W).to(dout.dtype)
        return ik.intra_conv_df, plain, (args[0], args[1], args[3])
    entry = {k.name: k for k in kernels.KERNELS}[name]
    # the df's plain version takes no inverse adjacency
    pick = {'intra_conv_prenorm_df': (0, 1, 2, 3, 5, 6)}.get(name)
    return (getattr(entry.module, name), getattr(entry.module, entry.plain),
            args if pick is None else tuple(args[i] for i in pick))


def train_tol(name, dtype):
    """The bound on the normwise relative error of each output of a train
    step's kernel call against its plain version: None (equal) for the
    index kernels; in fp32 1e-5, 1e-4 for the dW reductions (up to ~0.5 M
    rows); in bf16 8e-3 for bf16 outputs and 1e-3 for fp32 ones (dT before
    its rounding, the dW reductions, the moments' sums, dss)."""
    import torch
    if name in ('fps', 'ball_query'):
        return lambda out: None
    if dtype == 'fp32':
        tol = 1e-4 if name.endswith('_dw') else 1e-5
        return lambda out: tol
    return lambda out: 8e-3 if out.dtype == torch.bfloat16 else 1e-3


def fwd_tol(name, dtype):
    """The bound on the normwise relative error of each output of a
    forward's kernel call against its plain version (phases 2 and 7): None
    (equal) for the index kernels; 1e-5 for fp32 outputs, 4e-3 for bf16
    ones."""
    import torch
    if name in ('fps', 'ball_query'):
        return lambda out: None
    return lambda out: 4e-3 if out.dtype == torch.bfloat16 else 1e-5


def compare_outputs(got, want, tol):
    """(per-output errors, all within bounds) of a kernel call's outputs
    against its plain version's: ``tol(output)`` is the bound on the
    normwise relative error, or None for equality (the index difference
    is the error)."""
    import torch
    rels, ok = [], True
    for g, w in zip(got, want):
        t = tol(g)
        if t is None:
            rels.append(float((g.long() - w.long()).abs().max()))
            ok = ok and torch.equal(g, w)
        else:
            rels.append(rel_err(g, w))
            ok = ok and g.dtype == w.dtype and g.shape == w.shape and \
                rels[-1] <= t and bool(torch.isfinite(g).all())
    return rels, ok


def check_call(kern_fn, plain_fn, args, pargs, tol):
    """A kernel call against its plain version on the same inputs, each
    output against its counterpart (``tol(output)``: the bound on its
    normwise relative error, or None for equality), then both timed
    (median of 5 after 2 warm calls): (the kernel's outputs, a row)."""
    import torch
    got, want = kern_fn(*args), plain_fn(*pargs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rels, ok = compare_outputs(got, want, tol)
    row = {'max_abs_err': max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, want)),
           'rel_norm_err': max(rels), 'rels': rels, 'ok': ok,
           'ms': time_ms(lambda: kern_fn(*args), reps=5, warmup=2),
           'plain_ms': time_ms(lambda: plain_fn(*pargs), reps=5, warmup=2)}
    return got, row


# the yardstick of the fp32 W-fused inter forward (no one PyTorch call
# computes it): its composition, timed by inter_fwd_f32_times
INTER_YARD = 'F (epn_inter_conv_f_f32) + torch.mm(F, W)'
# the backward kernel calls of a train step, by compute dtype (in fp32 with
# the step's W-fused inter forwards)
BWD = {'fp32': ('inter_conv', 'inter_conv_dtable', 'inter_conv_dw',
                'intra_conv_df', 'intra_conv_dw'),
       'bf16': ('inter_conv_dtable', 'inter_conv_dw', 'intra_conv_prenorm_df',
                'intra_conv_prenorm_dw', 'grouped_conv_bwd')}


def _bwd_layer(name, n_calls, seen):
    """The model layer of a backward call (the backward runs from the last
    layer down): inter layers 6..1, intra layers 6..0, and the grouped conv
    at the head first, then the skips of layers 6..1; the step's inter
    forwards run first, layers 1..6."""
    if name == 'inter_conv':
        return f'L{seen + 1}'
    if name.startswith('inter'):
        return f'L{n_calls - seen}'
    if name.startswith('intra'):
        return f'L{n_calls - 1 - seen}'
    return 'head' if seen == 0 else f'L{n_calls - seen}'


def phase_backward_kernels(device, dtype='fp32'):
    """Each backward kernel call of one b=12 train step in ``dtype`` against
    its plain version on the same inputs, timed, with torch.mm beside the
    grouped conv's dx and dW. Normwise relative error <= 1e-5 for the fp32
    dTable and df, 1e-4 for the fp32 dW reductions (up to b*p*60 = 368,640
    rows); in bf16 <= 8e-3 for bf16 outputs and 1e-3 for fp32 ones."""
    import torch
    from epn_pointcloud_tpu_torch import models
    names = BWD[dtype]
    model = models.build_model_from(full_opt(), seed=SEED).to(device).train()
    batch = train_batch(device, SEED + (3 if dtype == 'fp32' else 5))
    with compute_dtype(dtype):
        calls = capture_calls(names + ('ones_conv',),
                              lambda: step_loss(model, batch).backward())
    del model
    tag = '[backward]' if dtype == 'fp32' else '[bf16-backward]'
    # the step's ones conv (its forward's block 0 layer 0), held apart
    ones = [c for c in calls if c[0] == 'ones_conv']
    calls = [c for c in calls if c[0] != 'ones_conv']
    n_calls = {n: sum(1 for c in calls if c[0] == n) for n in names}
    seen = dict.fromkeys(names, 0)
    results = {n: [] for n in names}
    failures = []
    torch.set_grad_enabled(False)
    for name, args in calls:
        kern_fn, plain_fn, pargs = _kernel_pair(name, args)
        layer = _bwd_layer(name, n_calls[name], seen[name])
        seen[name] += 1
        got, row = check_call(kern_fn, plain_fn, args, pargs,
                              train_tol(name, dtype))
        row.update(layer=layer, shape=' '.join(str(tuple(g.shape))
                                               for g in got))
        row['bytes_ms'], row['ops_ms'] = bound_ms(name, args, got)
        row.update(grouped_library(name, args))
        row.update(mm_library(name, args))
        row.update(intra_conv_extras(name, args, got))
        row.update(inter_conv_extras(name, args, got[0]))
        row.update(inter_bwd_extras(name, args, got[0]))
        row.update(inter_dw_extras(name, args, got[0]))
        row.update(intra_dw_extras(name, args, got[0]))
        row['ok'] = row['ok'] and _extras_ok(row)
        lib = _library_note(row)
        log(f'{tag} {name} {layer} (out {row["shape"]}, {got[0].dtype}): '
            f'max_abs_err={row["max_abs_err"]:.3e} rel_norm_err='
            f'{" ".join(f"{r:.3e}" for r in row["rels"])} kernel_ms='
            f'{row["ms"]:.4f} plain_ms={row["plain_ms"]:.4f}{lib} bound_ms='
            f'{max(row["bytes_ms"], row["ops_ms"]):.4f} '
            f'{"OK" if row["ok"] else "FAIL"}')
        results[name].append(row)
        if not row['ok']:
            failures.append(f'{name} {layer}')
        del got
    torch.set_grad_enabled(True)
    results['ones_conv_train'] = check_ones_calls(tag, ones, dtype)
    per_step = TRAIN_PER_STEP if dtype == 'fp32' else BF16_TRAIN_PER_STEP
    if len(ones) != per_step['ones_conv']:
        failures.append(f'{dtype} step ones conv calls {len(ones)}')
    # the fp32 intra df runs the forward intra kernel: 7 of its 14 launches
    expect = {n: 7 if n == 'intra_conv_df' else per_step[n] for n in names}
    if n_calls != expect:
        failures.append(f'{dtype} backward calls {n_calls}, expected {expect}')
    if failures:
        raise AssertionError(f'{dtype} backward kernel comparisons failed: '
                             f'{failures}')
    if dtype == 'fp32':
        check_fp32_rows(tag, results['inter_conv_dw'],
                        per_step['inter_conv_dw'])
        check_fp32_rows(tag, results['intra_conv_dw'],
                        per_step['intra_conv_dw'], 'intra dW',
                        'torch.mm(A^T, dout)', 1.5)
        check_fp32_rows(tag, results['intra_conv_df'], expect['intra_conv_df'],
                        'intra df', 'torch.mm(A_inv, W^T)', 1.5, 'fwd_f32',
                        1e-5)
        check_fp32_rows(tag, results['inter_conv'], expect['inter_conv'],
                        'inter forward', INTER_YARD, 1.5, 'fwd_f32', 1e-5,
                        'composed_ms')
        # the step's forwards, apart from phase 2's b=32 forward calls
        results['inter_conv_train'] = results.pop('inter_conv')
    return results


# per-leaf gradient cosine floor of the bf16 step, kernel vs plain path. Not
# 0.999: a bf16 step's gradients move by cosines of 0.96-0.99 when a few bf16
# roundings flip (the clouds scaled by 1 + 1e-6 do it; so does any other
# rounding order), on either path and in the JAX package; the kernels'
# own agreement is held per call in [bf16-backward]. This floor catches a
# gradient that misses a term.
BF16_LEAF_COS = 0.9
# the noise floor's draws: the kernel path on the batch's clouds or patches
# scaled by each (the lowest of the three medians is the floor)
NOISE_SCALES = (1 + 1e-6, 1 - 1e-6, 1 + 2e-6)


def _leaf_cos(a, b):
    import torch
    return float(torch.nn.functional.cosine_similarity(
        a.double().flatten(), b.double().flatten(), dim=0))


def bf16_step_check(tag, models, loss, batch, scaled, per_step, f64, what):
    """One bf16 step on the kernel path (``models[0]``) and on the plain
    path (``models[1]``) from the same weights, an fp32 step
    (``models[2]``), and the kernel path again on each batch of ``scaled``,
    the batch's ``what`` scaled by each of NOISE_SCALES (``models[3:]``:
    three draws of what a few flipped bf16 roundings alone do to the
    gradients, the floor of any comparison of two bf16 steps). Gates: the
    launches ``per_step`` and none on the plain path, the loss to rtol
    1e-3, a finite fp32 gradient for every parameter on both paths, and per
    leaf: cosine >= BF16_LEAF_COS where the float64 gradient (``f64``, max
    |g| a leaf) is real, with a median no lower than the lowest of the three
    draws' medians less 0.02; a degenerate leaf's kernel gradient at most 4
    times the plain one's plus 1e-2; every B6 dW call of the kernel path
    within 1e-3 of its plain version, on the tensor-core dW
    (``check_dw_calls``). The bf16 vs fp32 cosines are printed, not
    gated."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    mk, mp, m32 = models[:3]
    mqs = models[3:]
    with compute_dtype('bf16'):
        kernels.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with recording('intra_conv_prenorm_dw') as dw_calls:
            loss_k = loss(mk, batch)
            loss_k.backward()
        torch.cuda.synchronize()
        mem_k = torch.cuda.max_memory_allocated() / 2 ** 30
        counts_k = kernels.counts()
        dw_rels = check_dw_calls(tag, dw_calls, route_counts(),
                                 per_step['intra_conv_prenorm_dw'])
        del dw_calls
        torch.cuda.reset_peak_memory_stats()
        with kernels.plain():
            loss_p = loss(mp, batch)
            loss_p.backward()
        torch.cuda.synchronize()
        mem_p = torch.cuda.max_memory_allocated() / 2 ** 30
        counts_p = kernels.counts()
        loss_q = []
        for mq, sb in zip(mqs, scaled):
            lq = loss(mq, sb)
            lq.backward()
            loss_q.append(lq.item())
    assert counts_p == counts_k, 'the plain path launched a kernel'
    assert counts_k == per_step, (counts_k, per_step)
    loss_32 = loss(m32, batch)
    loss_32.backward()
    lk, lp, l32 = loss_k.item(), loss_p.item(), loss_32.item()
    log(f'{tag} bf16 loss kernel path {lk:.7f}, plain path {lp:.7f} (rtol '
        f'1e-3), kernel path on the {what} x {NOISE_SCALES} '
        f'{", ".join(f"{q:.7f}" for q in loss_q)}; fp32 kernel path '
        f'{l32:.7f}; peak device memory kernel path {mem_k:.2f} GiB, plain '
        f'path {mem_p:.2f} GiB; launches {counts_k}')
    assert math.isfinite(lk) and abs(lk - lp) <= 1e-3 * abs(lp), (lk, lp)
    no_grad = [n for m in (mk, mp) for n, p in m.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or p.grad.dtype != torch.float32]
    assert not no_grad, f'parameters without a finite fp32 gradient: ' \
        f'{no_grad}'
    pk, p32 = (dict(m.named_parameters()) for m in (mk, m32))
    pqs = [dict(m.named_parameters()) for m in mqs]
    bad, degen, leaves = [], [], {}
    for name, p in mp.named_parameters():
        gk, gp = pk[name].grad, p.grad
        mk_, mp_ = float(gk.abs().max()), float(gp.abs().max())
        cos_32 = _leaf_cos(gk, p32[name].grad)
        if f64[name] <= 1e-5:
            ok = mk_ <= 4 * mp_ + 1e-2
            degen.append(f'{name} (fp64 {f64[name]:.1e}: kernel {mk_:.2e}, '
                         f'plain {mp_:.2e})')
            leaves[name] = {'degenerate': True, 'kernel_max': mk_,
                            'plain_max': mp_, 'f64_max': f64[name],
                            'cos_vs_fp32': cos_32}
        else:
            cos = _leaf_cos(gk, gp)
            ok = cos >= BF16_LEAF_COS
            leaves[name] = {'cos': cos, 'cos_noise': [
                _leaf_cos(gk, pq[name].grad) for pq in pqs],
                'cos_vs_fp32': cos_32}
        if not ok:
            bad.append(f'{name}: {leaves[name]}')
    real = {n: v for n, v in leaves.items() if 'cos' in v}
    worst = min(real, key=lambda n: real[n]['cos'])
    cos_kp, c32 = (sorted(v[k] for v in real.values())
                   for k in ('cos', 'cos_vs_fp32'))
    cos_qs = [sorted(v['cos_noise'][i] for v in real.values())
              for i in range(len(mqs))]
    med_kp = statistics.median(cos_kp)
    med_qs = [statistics.median(c) for c in cos_qs]
    med_q = min(med_qs)
    draws = '; '.join(f'x {sc}: min {c[0]:.5f}, median {m:.5f}'
                      for sc, c, m in zip(NOISE_SCALES, cos_qs, med_qs))
    log(f'{tag} gradients: every one of {len(leaves)} parameters has one on '
        f'both paths; per-leaf cosine over {len(real)} real leaves, kernel '
        f'vs plain path min {cos_kp[0]:.5f} (>= {BF16_LEAF_COS}) at {worst}, '
        f'median {med_kp:.5f}; kernel path vs itself on the {what} {draws} '
        f'(the kernel vs plain median must be >= the lowest, {med_q:.5f}, '
        f'- 0.02); {len(degen)} degenerate leaves: {"; ".join(degen)}')
    log(f'{tag} bf16 vs fp32 step (kernel paths, same weights and batch): '
        f'loss {lk:.6f} vs {l32:.6f}; per-leaf gradient cosine min '
        f'{c32[0]:.5f}, median {statistics.median(c32):.5f} (printed, not '
        f'gated)')
    if med_kp < med_q - 0.02:
        bad.append(f'median kernel vs plain cosine {med_kp:.5f} below the '
                   f'noise floor {med_q:.5f} - 0.02')
    assert not bad, bad
    return {'loss_kernel': lk, 'loss_plain': lp, 'loss_fp32': l32,
            'min_grad_cos': cos_kp[0], 'median_grad_cos': med_kp,
            'noise_min_grad_cos': min(c[0] for c in cos_qs),
            'noise_median_grad_cos': med_q, 'noise_median_draws': med_qs,
            'min_grad_cos_vs_fp32': c32[0], 'peak_gib_kernel': mem_k,
            'peak_gib_plain': mem_p, 'dw_rel_norm_errs': dw_rels,
            'launches': counts_k, 'leaves': leaves}


def phase_bf16_train_step(device, reps=5):
    """[bf16-train] One b=12 bf16 train step on the kernel path and on the
    plain path from the same weights (``bf16_step_check``), the running
    statistics; the whole step timed on both."""
    import torch
    from epn_pointcloud_tpu_torch import models
    models_ = tuple(perturb_norm_biases(models.build_model_from(
        full_opt(), seed=SEED)).to(device).train()
        for _ in range(3 + len(NOISE_SCALES)))
    mk, mp = models_[:2]
    batch = train_batch(device, SEED + 6)
    out = bf16_step_check(
        f'[bf16-train] b={TRAIN_BATCH}', models_, step_loss, batch,
        [(batch[0] * sc,) + batch[1:] for sc in NOISE_SCALES],
        BF16_TRAIN_PER_STEP, f64_grad_max(mp, batch), 'clouds')
    bk = dict(mk.named_buffers())
    n_stats, stat_err = 0, 0.0
    for name, buf in mp.named_buffers():
        if 'running' in name:
            err = float((bk[name] - buf).abs().max())
            assert err <= 1e-3 * float(buf.abs().max()) + 1e-6, (name, err)
            stat_err = max(stat_err, err)
            n_stats += 1
    log(f'[bf16-train] BatchNorm running stats: {n_stats} buffers, max abs '
        f'diff {stat_err:.3e} (<= 1e-3 of each buffer\'s magnitude)')
    del models_
    _, k_ms, p_ms, k_ts, p_ts = time_steps(mk, mp, batch, 'bf16', reps)
    del mk, mp
    torch.cuda.empty_cache()
    out.update(kernel_ms=k_ms, plain_ms=p_ms, kernel_runs_ms=k_ts,
               plain_runs_ms=p_ts)
    return out


def phase_train_entry(dtype='fp32'):
    """A main path: run_modelnet train on a synthetic tree (--compute-dtype
    bf16: this slice's), then the saved checkpoint through run_modelnet
    eval -r in the same dtype."""
    import torch
    from epn_pointcloud_tpu_torch import run_modelnet
    from epn_pointcloud_tpu_torch.data import synthetic
    from epn_pointcloud_tpu_torch.ops import kernels, so3conv
    tag = '[train-entry]' if dtype == 'fp32' else '[bf16-train-entry]'
    per_step, per_eval = ((TRAIN_PER_STEP, EVAL_PER_BATCH) if dtype == 'fp32'
                          else (BF16_TRAIN_PER_STEP, BF16_EVAL_PER_BATCH))
    tree = os.path.join(WORK_DIR, 'modelnet')
    runs = os.path.join(WORK_DIR, 'runs')
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    synthetic.make_modelnet_tree(tree, n_cats=4, n_train=9, n_test=3,
                                 n_points=N_POINTS, seed=0,
                                 splits=('train', 'testR'))
    steps = 4
    common = ['--compute-dtype', dtype, '--model-dir', runs]
    try:
        kernels.reset_counts()
        t0 = time.time()
        trainer = run_modelnet.main(
            ['experiment', '-d', tree, '--run-mode', 'train', '-i',
             str(steps), '--save-freq', str(steps), '-lf', '1'] + common)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.counts()
        check_routes(tag, dtype, counts, route_counts())
        trainer.logger.close()
        n_eval = len(trainer.eval_logits)
        stats = dict(trainer.summary.running_stats)
        log(f'{tag} run_modelnet train --compute-dtype {dtype}: {steps} '
            f'steps of {TRAIN_BATCH} over {len(trainer.dataset)} batches an '
            f'epoch, eval of {n_eval} batch(es) at step {steps}; running '
            f'stats {stats}; wall {wall:.2f} s (data and setup included); '
            f'kernel launches {counts}, a step '
            f'{ {n: k for n, k in per_step.items() if k} }')
        assert all(math.isfinite(stats[k]) for k in ('Loss', 'R_Loss'))
        assert math.isfinite(float(trainer.last_loss))
        assert all(p.dtype == torch.float32 and p.grad is not None
                   for p in trainer.model.parameters())
        expect = {n: steps * per_step[n] + n_eval * per_eval[n]
                  for n in per_step}
        assert n_eval >= 1 and counts == expect, (counts, expect)
        ckpt = trainer.last_ckpt
        assert os.path.exists(ckpt), ckpt
        other = run_modelnet.main(['experiment', '-d', tree, '--run-mode',
                                   'eval', '-b', str(TRAIN_BATCH), '-r',
                                   ckpt] + common)
        other.logger.close()
    finally:
        so3conv.set_compute_dtype('fp32')
    got, want = torch.cat(other.eval_logits), torch.cat(trainer.eval_logits)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    log(f'{tag} checkpoint {os.path.basename(ckpt)} served through '
        f'--run-mode eval --compute-dtype {dtype} -r: logits '
        f'{tuple(got.shape)} equal the trained model\'s (max abs diff '
        f'{float((got - want).abs().max()):.3e})')
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return counts, wall


# ----------------------------------------------- inv_so3net_pn (3DMatch)

INV_DIR = os.path.join(ROOT, 'build', 'chip_smoke_3dmatch')
INV_BATCH = 16          # patch pairs a leg: the 3DMatch entry's npt
INV_DESC_BATCH = 48
INV_LAYERS = ('B0L0', 'B0L1', 'B1L0', 'B1L1', 'B2L0', 'B2L1', 'B3L0', 'B3L1')
# the layers whose backward composes (c <= 32 or nn > 32), and the others
INV_COMPOSED = ('B0L1', 'B1L0', 'B2L0', 'B3L0')
INV_FUSED = ('B1L1', 'B2L1', 'B3L1')
# kernel launches of one fp32 inv triplet step (two legs): per leg one fps,
# 8 ball queries, the ones conv at B0L0, the W-fused inter conv at the other
# 7 layers, the intra conv at all 8 forward and again as df; intra dW at 8;
# the fused dTable / dW at the 3 fused layers; inter_conv_f (the F
# recompute) and inter_conv_dg at the 4 composed ones
INV_PER_STEP = {**_NO_BF16, 'fps': 2, 'ball_query': 16, 'ones_conv': 2,
                'inter_conv': 14, 'intra_conv': 32, 'intra_conv_dw': 16,
                'inter_conv_dtable': 6, 'inter_conv_dw': 6,
                'inter_conv_f': 8, 'inter_conv_dg': 8}
INV_NAMES = ('fps', 'ball_query', 'ones_conv', 'inter_conv', 'intra_conv',
             'intra_conv_df', 'intra_conv_dw', 'inter_conv_dtable',
             'inter_conv_dw', 'inter_conv_f', 'inter_conv_dg')
# kernel launches of one bf16 inv triplet step. A leg's forward: fps, 8
# ball queries, the ones conv at B0L0, the W-fused inter conv at the other
# 7 layers, the prenorm intra conv at all 8 (the inter InstanceNorm
# deferred into it as a fold a patch), the moments kernel for the inter and
# the intra InstanceNorm at all 8 and the packed skip InstanceNorm at 7
# (B0L0's rank-1 skip runs unpacked, in plain torch, as in the JAX
# package), the grouped conv at those 7 skips; no fused tail (InstanceNorm
# blocks). The backward: the fused dTable / dW at the 3 fused layers,
# inter_conv_f and inter_conv_dg at the 4 composed ones, the prenorm intra
# df and dW at 8, the grouped conv backward at 7
INV_BF16_PER_STEP = {**INV_PER_STEP, 'intra_conv': 0, 'intra_conv_dw': 0,
                     'intra_conv_prenorm': 16, 'intra_conv_prenorm_df': 16,
                     'intra_conv_prenorm_dw': 16, 'moments': 46,
                     'grouped_conv': 14, 'grouped_conv_bwd': 14}
INV_BF16_NAMES = ('fps', 'ball_query', 'ones_conv', 'inter_conv',
                  'intra_conv_prenorm', 'moments', 'grouped_conv',
                  'inter_conv_dtable', 'inter_conv_dw', 'inter_conv_f',
                  'inter_conv_dg', 'intra_conv_prenorm_df',
                  'intra_conv_prenorm_dw', 'grouped_conv_bwd')
# the moments calls of a leg's forward: the inter and the intra
# InstanceNorm of every layer, and the packed skip's from B0L1 on
INV_MOMENTS = tuple(f'{layer}.{norm}' for layer in INV_LAYERS
                    for norm in ('inter', 'intra', 'skip')
                    if layer != 'B0L0' or norm != 'skip')
# the layer whose fp32 inter W gradient differed most between the kernel
# and the plain path in the first inv step measured (3.2e-3 relative L2)
INV_GAP_LEAF = 'backbone.0.blocks.1.inter_conv.conv.basic_conv.W'


def inv_tree():
    """The dense synthetic 3DMatch tree of
    tests/test_reference_entrypoint_parity.py:273-275 (every keypoint's 0.4
    ball holds >= 1024 distinct points), 3 fragments, 32 keypoints."""
    from epn_pointcloud_tpu_torch.data import synthetic
    root = os.path.join(INV_DIR, 'data')
    if not os.path.isdir(root):
        synthetic.make_3dmatch_tree(root, n_frags=3, n_points=32000,
                                    n_kpts=32, seed=11,
                                    extent=(2.0, 2.0, 1.6), kpt_margin=0.45)
    return root


def inv_opt(root):
    """The 3DMatch entry point's options (config_opt_3dmatch, train)."""
    from epn_pointcloud_tpu_torch import run_3dmatch
    from epn_pointcloud_tpu_torch.app import config
    return run_3dmatch.config_opt_3dmatch(config.parse_args(
        ['experiment', '-d', root]))


def inv_legs(root, device, items=(0,)):
    """(src, tgt) [16 * len(items), 1024, 3] patch legs from the port's
    FragmentLoader on the tree, its items drawn in turn (each draw samples
    fresh keypoints: (0, 1, 0) are three different batches)."""
    import numpy as np
    import torch
    from epn_pointcloud_tpu_torch.data import match_3dmatch
    loader = match_3dmatch.FragmentLoader(inv_opt(root), 0.4, npt=INV_BATCH)
    data = [loader[i] for i in items]
    return tuple(torch.from_numpy(np.concatenate([d[k] for d in data])).to(
        device) for k in ('src', 'tgt'))


def inv_batches(root, device, n):
    """n triplet-step batches, each a (src, tgt) pair of b=16 legs, drawn
    in turn from one FragmentLoader (the first is inv_legs(root)'s)."""
    legs = inv_legs(root, device, items=tuple(i % 2 for i in range(n)))
    return [tuple(x[INV_BATCH * i:INV_BATCH * (i + 1)] for x in legs)
            for i in range(n)]


def inv_model(device):
    from epn_pointcloud_tpu_torch import models
    return models.build_model_from(inv_opt('unused'), seed=SEED).to(device)


def inv_loss(model, legs):
    """The triplet step's loss: one model call a leg, the soft in-batch
    hard-negative triplet loss (margin 1) on the two descriptor sets."""
    from epn_pointcloud_tpu_torch import losses
    ys, _ = model(legs[0])
    yt, _ = model(legs[1])
    return losses.triplet_batch_loss(ys, yt, 'soft', 1.0)[0]


def _step_layer(name, i, layers=INV_LAYERS, composed=INV_COMPOSED,
                fused=INV_FUSED, moments=INV_MOMENTS):
    """'<layer>#<forward>' of the i-th call of ``name`` in one step of a
    model with ``layers`` (the inv model's by default; its backward
    composed at ``composed``, fused at ``fused``): the forwards (the inv
    step's two legs) in turn, then the backward, which runs from the last
    layer down, a forward at a time."""
    per_leg = {'fps': ('B0L0',), 'ones_conv': ('B0L0',),
               'ball_query': layers, 'intra_conv': layers,
               'intra_conv_prenorm': layers, 'moments': moments,
               'inter_conv': layers[1:], 'grouped_conv': layers[1:],
               'intra_conv_df': layers[::-1],
               'intra_conv_dw': layers[::-1],
               'intra_conv_prenorm_df': layers[::-1],
               'intra_conv_prenorm_dw': layers[::-1],
               'grouped_conv_bwd': layers[:0:-1],
               'inter_conv_f': composed[::-1],
               'inter_conv_dg': composed[::-1],
               'dw_product': composed[::-1],
               'inter_conv_dtable': fused[::-1],
               'inter_conv_dw': fused[::-1]}[name]
    return f'{per_leg[i % len(per_leg)]}#{i // len(per_leg)}'


# the kernels that take the activation's slope, their last argument
SLOPED = ('intra_conv_prenorm', 'intra_conv_prenorm_df',
          'intra_conv_prenorm_dw', 'grouped_conv_tail')


def _log_row(tag, name, layer, row):
    slope = f' slope={row["slope"]}' if 'slope' in row else ''
    log(f'{tag} {name} {layer} ({row["shape"]}, {row["dtype"]}{slope}): '
        f'max_abs_err={row["max_abs_err"]:.3e} rel_norm_err='
        f'{" ".join(f"{r:.3e}" for r in row["rels"])} kernel_ms='
        f'{row["ms"]:.4f} plain_ms={row["plain_ms"]:.4f}'
        f'{_library_note(row)} bound_ms='
        f'{max(row["bytes_ms"], row["ops_ms"]):.4f} '
        f'({"bytes" if row["bytes_ms"] >= row["ops_ms"] else "ops"}) '
        f'{"OK" if row["ok"] else "FAIL"}')


def check_step_calls(tag, calls, names, dtype, layer_of=_step_layer,
                     tol=train_tol, routes=REDESIGNED):
    """Each captured kernel call of a train step (``calls``) against its
    plain version on the same inputs, timed, by ``tol`` (``train_tol``; a
    forward's calls: ``fwd_tol``), with the extras of its kernel (phase
    12's checks; ``routes``: the kernels ``_extras_ok`` lets a row have
    run); the composed route's bf16 dW product against float64
    (``inv_dw_product_row``). Returns (rows by name, the calls that failed,
    the calls by name)."""
    import torch
    n_calls = {n: sum(1 for c in calls if c[0] == n) for n in names}
    seen = dict.fromkeys(names, 0)
    results = {n: [] for n in names}
    failures = []
    for name, args in calls:
        layer = layer_of(name, seen[name])
        seen[name] += 1
        if name == 'dw_product':
            row = inv_dw_product_row(layer, *args)
        else:
            kern_fn, plain_fn, pargs = _kernel_pair(name, args)
            got, row = check_call(kern_fn, plain_fn, args, pargs,
                                  tol(name, dtype))
            row.update(layer=layer, dtype=str(got[0].dtype),
                       shape=' '.join(str(tuple(a.shape)) for a in args[:3]
                                      if torch.is_tensor(a)))
            # the fp32 intra df is the forward kernel on W transposed
            wname, wargs = (('intra_conv', (args[0], args[1],
                                            args[3].transpose(1, 2)))
                            if name == 'intra_conv_df' else (name, args))
            row['bytes_ms'], row['ops_ms'] = bound_ms(
                wname, wargs, got[0] if len(got) == 1 else got)
            if name in SLOPED:
                row['slope'] = args[-1]
            row.update(grouped_library(name, args))
            row.update(moments_library(name, args))
            row.update(device_extras(name, args))
            row.update(sampling_extras(name, args, got[0]))
            row.update(ones_conv_extras(name, args, got[0]))
            row.update(mm_library(name, args))
            row.update(inter_conv_extras(name, args, got[0]))
            row.update(intra_conv_extras(name, args, got))
            row.update(inter_bwd_extras(name, args, got[0]))
            row.update(inter_dw_extras(name, args, got[0]))
            row.update(intra_dw_extras(name, args, got[0]))
            row.update(inter_f_extras(name, args, got[0]))
            row['ok'] = row['ok'] and _extras_ok(row, routes)
            _log_row(tag, name, layer, row)
            del got
        results[name].append(row)
        if not row['ok']:
            failures.append(f'{name} {layer}')
    return results, failures, n_calls


def check_fp32_step_rows(tag, results, expect, per_step):
    """phase 12's checks of the fp32 CUDA-core kernels over one step's
    rows (``check_fp32_rows``); the intra df's rows then join the intra
    forward's."""
    check_fp32_rows(tag, results['inter_conv_dw'], per_step['inter_conv_dw'])
    check_fp32_rows(tag, results['intra_conv_dw'], per_step['intra_conv_dw'],
                    'intra dW', 'torch.mm(A^T, dout)', 1.5)
    for name, what, mm in (('intra_conv', 'intra forward', 'torch.mm(A, W)'),
                           ('intra_conv_df', 'intra df',
                            'torch.mm(A_inv, W^T)')):
        check_fp32_rows(tag, results[name], expect[name], what, mm, 1.5,
                        'fwd_f32', 1e-5)
    check_fp32_rows(tag, results['inter_conv'], expect['inter_conv'],
                    'inter forward', INTER_YARD, 1.5, 'fwd_f32', 1e-5,
                    'composed_ms')
    results['intra_conv'] += results.pop('intra_conv_df')


def phase_inv_kernels(device, legs, dtype='fp32'):
    """[inv-kernels], [inv-bf16-kernels] Each kernel call of one inv triplet
    step (b=16 a leg) in ``dtype`` against its plain version on the same
    inputs, timed, by ``train_tol``: fps and ball_query indices equal; fp32
    normwise <= 1e-5 (the forward kernels, intra df, dTable, F and dT by
    atomics), <= 1e-4 for the dW reductions; bf16 <= 8e-3 for bf16 outputs,
    <= 1e-3 for fp32 ones. fp32: then, at B1L0, B2L0 and B3L0, the composed
    backward route (dF product, inter_conv_dg, inter_conv_f, dW product)
    timed beside the fused dTable + dW on the same operands (printed, not
    gated). bf16: the composed route's dW product against its float64
    product at each composed layer (``inv_dw_product_row``)."""
    import torch
    fp32 = dtype == 'fp32'
    names = INV_NAMES if fp32 else INV_BF16_NAMES + ('dw_product',)
    tag = '[inv-kernels]' if fp32 else '[inv-bf16-kernels]'
    model = inv_model(device).train()
    with compute_dtype(dtype):
        calls = capture_calls(names, lambda: inv_loss(model, legs).backward())
    del model
    torch.set_grad_enabled(False)
    results, failures, n_calls = check_step_calls(tag, calls, names, dtype)
    routes = inv_route_times(calls, device) if fp32 else None
    torch.set_grad_enabled(True)
    per_step = INV_PER_STEP if fp32 else INV_BF16_PER_STEP
    expect = {n: per_step.get(n, 0) for n in names}
    if fp32:
        expect['intra_conv'], expect['intra_conv_df'] = 16, 16
    else:
        expect['dw_product'] = per_step['inter_conv_f']
    if n_calls != expect:
        failures.append(f'{dtype} inv step calls {n_calls}, expected '
                        f'{expect}')
    if failures:
        raise AssertionError(f'{dtype} inv kernel comparisons failed: '
                             f'{failures}')
    if fp32:
        check_fp32_step_rows(tag, results, expect, per_step)
    return results, routes


def inv_route_times(calls, device):
    """The composed backward (dF = dout W^T, inter_conv_dg, inter_conv_f,
    dW = F^T dout) and the fused one (inter_conv_dtable + inter_conv_dw) at
    B1L0, B2L0 and B3L0 of the first leg, on that layer's forward operands
    and a seeded dout; each part timed (median of 5)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    ic = kernels.inter_conv
    fwd = [args for name, args in calls if name == 'inter_conv'][:7]
    out = {}
    g = torch.Generator(device=device).manual_seed(SEED)
    for layer in INV_COMPOSED[1:]:
        gx, idx, table, rk, k2, W, sigma = fwd[INV_LAYERS.index(layer) - 1]
        b, p2, _ = idx.shape
        q, na, c = table.shape[1:]
        K, d = W.shape[0], W.shape[2]
        dout = torch.randn((b, p2, na, d), generator=g, device=device)
        W2 = W.reshape(K * c, d)
        dF = torch.matmul(dout.reshape(-1, d), W2.t()).reshape(
            b, p2, na, K, c)
        F = ic.inter_conv_f(gx, idx, table, rk, k2, sigma)
        parts = {
            'dF_mm': lambda: torch.matmul(dout.reshape(-1, d), W2.t()),
            'inter_conv_dg': lambda: ic.inter_conv_dg(gx, idx, q, rk, k2, dF,
                                                      sigma),
            'inter_conv_f': lambda: ic.inter_conv_f(gx, idx, table, rk, k2,
                                                    sigma),
            'dW_mm': lambda: torch.matmul(F.reshape(-1, K * c).t(),
                                          dout.reshape(-1, d)),
            'inter_conv_dtable': lambda: ic.inter_conv_dtable(
                gx, idx, q, rk, k2, W, dout, sigma),
            'inter_conv_dw': lambda: ic.inter_conv_dw(gx, idx, table, rk, k2,
                                                      dout, sigma)}
        ms = {k: time_ms(fn, reps=5, warmup=2) for k, fn in parts.items()}
        dT_c, dT_f = parts['inter_conv_dg'](), parts['inter_conv_dtable']()
        dW_c, dW_f = parts['dW_mm']().reshape(K, c, d), parts[
            'inter_conv_dw']()
        composed = ms['dF_mm'] + ms['inter_conv_dg'] + ms['inter_conv_f'] + \
            ms['dW_mm']
        fused = ms['inter_conv_dtable'] + ms['inter_conv_dw']
        out[layer] = {'shape': f'b={b} p2={p2} nn={idx.shape[2]} c={c} d={d}',
                      'parts_ms': ms, 'composed_ms': composed,
                      'fused_ms': fused, 'dT_rel_diff': rel_err(dT_c, dT_f),
                      'dW_rel_diff': rel_err(dW_c, dW_f)}
        log(f'[inv-kernels] backward routes at {layer} '
            f'({out[layer]["shape"]}): composed {composed:.3f} ms (dF mm '
            f'{ms["dF_mm"]:.3f} + dG {ms["inter_conv_dg"]:.3f} + F '
            f'{ms["inter_conv_f"]:.3f} + dW mm {ms["dW_mm"]:.3f}) vs fused '
            f'{fused:.3f} ms (dTable {ms["inter_conv_dtable"]:.3f} + dW '
            f'{ms["inter_conv_dw"]:.3f}); routes differ by dT '
            f'{out[layer]["dT_rel_diff"]:.2e}, dW '
            f'{out[layer]["dW_rel_diff"]:.2e} (printed, not gated)')
        del dF, F, dT_c, dT_f, dW_c, dW_f
    return out


def inv_f64_grads(model, legs, chunk=4):
    """Per-leaf gradient of the triplet step on a float64 copy of ``model``
    on the plain path. A patch's descriptor depends on that patch only
    (InstanceNorm normalizes each cloud alone), so the step's gradient is
    the sum over patches of dL/dy_i dy_i/dtheta: the descriptors first,
    dL/dy from the loss, then the backward ``chunk`` patches at a time (the
    b=16 legs' float64 step does not fit the card otherwise)."""
    import copy
    import torch
    from epn_pointcloud_tpu_torch import losses
    from epn_pointcloud_tpu_torch.ops import kernels
    m64 = copy.deepcopy(model).double()
    m64.zero_grad(set_to_none=True)
    xs = [x.double() for x in legs]
    with kernels.plain():
        with torch.no_grad():
            ys = [torch.cat([m64(x[i:i + chunk])[0]
                             for i in range(0, len(x), chunk)]) for x in xs]
        ys = [y.requires_grad_() for y in ys]
        gys = torch.autograd.grad(
            losses.triplet_batch_loss(ys[0], ys[1], 'soft', 1.0)[0], ys)
        for x, gy in zip(xs, gys):
            for i in range(0, len(x), chunk):
                (m64(x[i:i + chunk])[0] * gy[i:i + chunk]).sum().backward()
    out = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in m64.named_parameters()}
    del m64
    torch.cuda.empty_cache()
    return out


def _max_abs(grads):
    return {n: float(g.abs().max()) for n, g in grads.items()}


def inv_gap_row(i, gk, gp, g64):
    """The relative L2 against the float64 step of B0L1's inter W gradient
    (INV_GAP_LEAF) on the kernel and the plain path, and of the worst real
    leaf (float64 gradient > 1e-5) on each, for batch i."""
    real = [n for n, g in g64.items() if float(g.abs().max()) > 1e-5]

    def rel(a, n):
        return rel_err(a[n].double(), g64[n])
    row = {'batch': i, 'kernel_vs_f64': rel(gk, INV_GAP_LEAF),
           'plain_vs_f64': rel(gp, INV_GAP_LEAF),
           'kernel_vs_plain': rel_err(gk[INV_GAP_LEAF], gp[INV_GAP_LEAF])}
    for path, g in (('kernel', gk), ('plain', gp)):
        worst = max(real, key=lambda n: rel(g, n))
        row[f'{path}_worst'] = (rel(g, worst), worst)
    log(f'[inv-train] batch {i}: B0L1 inter W gradient relative L2 kernel '
        f'path vs float64 {row["kernel_vs_f64"]:.3e}, plain path vs float64 '
        f'{row["plain_vs_f64"]:.3e}, kernel vs plain '
        f'{row["kernel_vs_plain"]:.3e}; worst real leaf vs float64: kernel '
        f'{row["kernel_worst"][0]:.3e} ({row["kernel_worst"][1]}), plain '
        f'{row["plain_worst"][0]:.3e} ({row["plain_worst"][1]})')
    return row


def phase_inv_train(device, batches, reps=5):
    """[inv-train] One fp32 inv triplet step (b=16 a leg) on the kernel
    path and on the plain path from the same weights: loss to rtol 1e-5,
    a gradient for every parameter on both, per-leaf agreement by the rule
    of tests/test_reference_train_parity.py; B0L1's inter W gradient on
    both paths against a float64 step, on each of ``batches`` (printed, not
    gated); the whole step timed on both paths in turns (median of 5); 10
    Adam steps on one batch lower the loss."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    legs = batches[0]
    mk, mp = (inv_model(device).train() for _ in range(2))
    g64 = inv_f64_grads(mp, legs)
    f64 = _max_abs(g64)
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    loss_k = inv_loss(mk, legs)
    loss_k.backward()
    torch.cuda.synchronize()
    mem_k = torch.cuda.max_memory_allocated() / 2 ** 30
    counts_k = kernels.counts()
    check_routes('[inv-train]', 'fp32', counts_k, route_counts())
    torch.cuda.reset_peak_memory_stats()
    with kernels.plain():
        loss_p = inv_loss(mp, legs)
        loss_p.backward()
    torch.cuda.synchronize()
    mem_p = torch.cuda.max_memory_allocated() / 2 ** 30
    assert kernels.counts() == counts_k, 'the plain path launched a kernel'
    assert counts_k == INV_PER_STEP, (counts_k, INV_PER_STEP)
    lk, lp = loss_k.item(), loss_p.item()
    log(f'[inv-train] b={INV_BATCH} a leg, loss kernel path {lk:.7f}, plain '
        f'path {lp:.7f} (rtol 1e-5); peak device memory kernel path '
        f'{mem_k:.1f} GiB, plain path {mem_p:.1f} GiB')
    assert math.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp), (lk, lp)
    no_grad = [n for m in (mk, mp) for n, p in m.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    assert not no_grad, f'parameters without a finite gradient: {no_grad}'
    bad, degen, worst = [], [], (0.0, '')
    pk = dict(mk.named_parameters())
    for name, p in mp.named_parameters():
        ok, msg = _grads_close(name, pk[name].grad, p.grad, f64[name])
        if not ok:
            bad.append(msg)
        elif 'degenerate' in msg:
            degen.append(msg)
        if f64[name] > 1e-5:
            worst = max(worst, (rel_err(pk[name].grad, p.grad), name))
    log(f'[inv-train] gradients: {len(pk)} leaves, every one on both paths, '
        f'worst relative L2 {worst[0]:.3e} at {worst[1]}; {len(degen)} '
        f'degenerate leaves (fp64 gradient <= 1e-5 or both <= 1e-3): '
        f'{"; ".join(degen)}')
    assert not bad, bad

    def grads(m):
        return {n: p.grad.detach().clone() for n, p in m.named_parameters()}
    gap = [inv_gap_row(0, grads(mk), grads(mp), g64)]
    for i, b in enumerate(batches[1:], 1):
        for m in (mk, mp):
            m.zero_grad(set_to_none=True)
        inv_loss(mk, b).backward()
        with kernels.plain():
            inv_loss(mp, b).backward()
        gap.append(inv_gap_row(i, grads(mk), grads(mp),
                               inv_f64_grads(mp, b)))
    del g64
    opt_k, k_ms, p_ms, k_ts, p_ts = time_steps(
        mk, mp, legs, 'fp32', reps, loss=inv_loss, tag='[inv-train]',
        n_clouds=2 * INV_BATCH)
    del mp
    torch.cuda.empty_cache()
    trace = []
    for i in range(11):
        loss = inv_loss(mk, legs)
        trace.append(loss.item())
        if i < 10:
            opt_k.zero_grad(set_to_none=True)
            loss.backward()
            opt_k.step()
    log(f'[inv-train] 10 Adam steps on one batch, kernel path: loss '
        f'{trace[0]:.4f} -> {trace[-1]:.4f}')
    assert all(map(math.isfinite, trace)) and trace[-1] < trace[0], trace
    del mk
    torch.cuda.empty_cache()
    return {'loss_kernel': lk, 'loss_plain': lp, 'kernel_ms': k_ms,
            'plain_ms': p_ms, 'kernel_runs_ms': k_ts, 'plain_runs_ms': p_ts,
            'worst_grad_rel_l2': worst[0], 'adam_trace': trace,
            'peak_gib_kernel': mem_k, 'peak_gib_plain': mem_p,
            'b0l1_gap': gap}


def check_inv_desc_inter(model, x):
    """Every W-fused inter forward of the b=48 descriptor forward (7) on
    its fp32 CUDA-core kernel, within 1e-5 (normwise) of inter_conv_plain,
    bitwise equal on a second call and at most 1.5 times the template's
    float64 error (``inter_fwd_f32_gate``)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    ic = kernels.inter_conv
    rows = []
    with torch.no_grad():
        calls = capture_calls(('inter_conv',), lambda: model(x))
        for _, args in calls:
            got = ic.inter_conv(*args)
            rows.append({'rel_norm_err': rel_err(got, ic.inter_conv_plain(
                *args)), **inter_fwd_f32_gate(args, got)})
            del got
    del calls
    torch.cuda.empty_cache()

    def col(key):
        return ' '.join(f'{r[key]:.2e}' for r in rows)
    ratios = [r['f64_ratio'] for r in rows]
    log(f'[inv-descriptor] fp32 inter forward: {len(rows)} calls, routes '
        f'{[r["route"] for r in rows]}; rel_norm_err vs plain '
        f'{col("rel_norm_err")} (<= 1e-5); vs float64 {col("rel_f64")}, the '
        f'template {col("template_rel_f64")}, ratio max {max(ratios):.3f} '
        f'(<= 1.5); bitwise {all(r["bitwise_repeat"] for r in rows)}')
    assert len(rows) == 7 and {r['route'] for r in rows} == {'fwd_f32'}
    assert all(r['bitwise_repeat'] for r in rows)
    assert max(r['rel_norm_err'] for r in rows) <= 1e-5
    assert max(ratios) <= 1.5, ratios
    return rows


def phase_inv_descriptor(device, root, reps=5):
    """[inv-descriptor] The eval-mode inv forward at b=48 patches on the
    kernel and the plain path: descriptors to rtol 1e-3, atol 2e-3; both
    timed in turns (median of 5); every fp32 inter forward of the kernel
    path checked by ``check_inv_desc_inter``."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    src, tgt = inv_legs(root, device, items=(0, 1))
    x = torch.cat([src, tgt])[:INV_DESC_BATCH].contiguous()
    model = inv_model(device).eval()
    inter_rows = check_inv_desc_inter(model, x)
    with torch.no_grad():
        ones = capture_calls(('ones_conv',), lambda: model(x))
    ones_rows = check_ones_calls('[inv-descriptor]', ones, 'fp32')
    del ones

    def plain_fwd():
        with kernels.plain():
            return model(x)[0]
    with torch.no_grad():
        yk, yp = model(x)[0], plain_fwd()
        torch.cuda.synchronize()
        k_ts, p_ts = [], []
        for _ in range(reps):
            k_ts.append(time_ms(lambda: model(x), reps=1, warmup=0))
            p_ts.append(time_ms(plain_fwd, reps=1, warmup=0))
    k_ms, p_ms = statistics.median(k_ts), statistics.median(p_ts)
    err = float((yk - yp).abs().max())
    log(f'[inv-descriptor] b={INV_DESC_BATCH} eval descriptors '
        f'{tuple(yk.shape)} kernel vs plain path max_abs_err={err:.3e} '
        f'(rtol 1e-3, atol 2e-3), norms {float(yk.norm(dim=1).min()):.6f}-'
        f'{float(yk.norm(dim=1).max()):.6f}; forward kernel path '
        f'{k_ms:.2f} ms ({1e3 * INV_DESC_BATCH / k_ms:.1f} patches/s), plain '
        f'path {p_ms:.2f} ms; median of {reps} turns')
    assert yk.shape == (INV_DESC_BATCH, 64) and torch.isfinite(yk).all()
    torch.testing.assert_close(yk, yp, rtol=1e-3, atol=2e-3)
    del model
    torch.cuda.empty_cache()
    return {'max_abs_err': err, 'kernel_ms': k_ms, 'plain_ms': p_ms,
            'kernel_runs_ms': k_ts, 'plain_runs_ms': p_ts,
            'inter_forward': inter_rows, 'ones_conv': ones_rows}


def phase_inv_train_entry(root, dtype='fp32'):
    """[inv-train-entry], [inv-bf16-train-entry] A main path (bf16: the
    one the kernels line reports): run_3dmatch --run-mode train
    --compute-dtype ``dtype`` -i 4 --save-freq 4 on the synthetic tree;
    finite logged losses, each kernel's launch count risen by its per-step
    count, params.json written; the checkpoint reloaded through -r in the
    same dtype, every tensor equal. Returns (launches, wall, the
    checkpoint)."""
    import torch
    from epn_pointcloud_tpu_torch import run_3dmatch
    from epn_pointcloud_tpu_torch.ops import kernels, so3conv
    tag = '[inv-train-entry]' if dtype == 'fp32' else '[inv-bf16-train-entry]'
    per_step = INV_PER_STEP if dtype == 'fp32' else INV_BF16_PER_STEP
    steps = 4
    common = ['experiment', '-d', root, '--run-mode', 'train',
              '--compute-dtype', dtype, '--model-dir',
              os.path.join(INV_DIR, 'runs')]
    try:
        kernels.reset_counts()
        t0 = time.time()
        trainer = run_3dmatch.main(common + ['-i', str(steps), '--save-freq',
                                             str(steps), '-lf', '1'])
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.counts()
        routes = route_counts()
        trainer.logger.close()
        ckpt = trainer.last_ckpt
        other = run_3dmatch.main(common + ['-i', '0', '-r', ckpt])
        other.logger.close()
    finally:
        so3conv.set_compute_dtype('fp32')
    stats = dict(trainer.summary.running_stats)
    log(f'{tag} run_3dmatch train --compute-dtype {dtype}: {steps} steps of '
        f'2 x {trainer.opt.npt} patches ({len(trainer.dataset)} fragment '
        f'pairs an epoch); running stats {stats}; wall {wall:.2f} s (data and '
        f'setup included); kernel launches {counts}, a step '
        f'{ {n: k for n, k in per_step.items() if k} }')
    check_routes(tag, dtype, counts, routes)
    assert trainer.opt.npt == INV_BATCH and trainer.opt.batch_size == 1
    assert all(math.isfinite(stats[k]) for k in ('Loss', 'Pos', 'Neg',
                                                 'Acc'))
    assert math.isfinite(float(trainer.last_loss))
    assert all(p.dtype == torch.float32 and p.grad is not None
               for p in trainer.model.parameters())
    expect = {n: steps * k for n, k in per_step.items()}
    assert counts == expect, (counts, expect)
    params_json = os.path.join(trainer.root_dir, 'params.json')
    with open(params_json) as f:
        assert json.load(f) == trainer.model.params, params_json
    for (k, a), (_, b) in zip(trainer.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), k
    log(f'{tag} params.json written; checkpoint {os.path.basename(ckpt)} '
        f'reloaded through -r --compute-dtype {dtype}: all '
        f'{len(trainer.model.state_dict())} tensors equal')
    return counts, wall, ckpt


def inv_dw_product_row(layer, F2, dout2):
    """The composed route's dW = F^T dout from bf16 operands
    (``inter_conv.dw_product``) against the float64 product of the same
    values: <= 1e-3 relative (fp32 sums over ~0.5 M rows give ~3e-5; a
    bf16 output alone ~1.6e-3). torch.matmul's default bf16 product (the
    flag allow_bf16_reduced_precision_reduction as it stands) is timed and
    measured beside it."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    dwp = kernels.inter_conv.dw_product
    got = dwp(F2, dout2)
    want = F2.double().t() @ dout2.double()
    default = torch.matmul(F2.t(), dout2)
    torch.cuda.synchronize()
    rel, rel_default = rel_err(got, want), rel_err(default, want)
    ok = got.dtype == torch.float32 and rel <= 1e-3 and \
        bool(torch.isfinite(got).all())
    ms = time_ms(lambda: dwp(F2, dout2), reps=5, warmup=2)
    default_ms = time_ms(lambda: torch.matmul(F2.t(), dout2), reps=5,
                         warmup=2)
    log(f'[inv-bf16-kernels] dw_product {layer} (F {tuple(F2.shape)} x dout '
        f'{tuple(dout2.shape)} bf16 -> fp32): rel_norm_err vs float64 '
        f'{rel:.3e} [1e-3] in {ms:.4f} ms; torch.matmul bf16 default '
        f'{rel_default:.3e} in {default_ms:.4f} ms {"OK" if ok else "FAIL"}')
    del want, default
    return {'layer': layer, 'rel_norm_err': rel, 'ms': ms,
            'default_rel_norm_err': rel_default, 'default_ms': default_ms,
            'ok': ok}


def phase_inv_bf16_train(device, legs, reps=5):
    """[inv-bf16-train] One bf16 inv triplet step (b=16 a leg) on the
    kernel path and on the plain path from the same weights by the rule of
    [bf16-train] (``bf16_step_check``; degenerate leaves from a float64
    step), with peak device memory; the whole step timed on both paths in
    turns (median of 5)."""
    import torch
    models_ = tuple(inv_model(device).train()
                    for _ in range(3 + len(NOISE_SCALES)))
    mk, mp = models_[:2]
    out = bf16_step_check(
        f'[inv-bf16-train] b={INV_BATCH} a leg,', models_, inv_loss, legs,
        [tuple(x * sc for x in legs) for sc in NOISE_SCALES],
        INV_BF16_PER_STEP, _max_abs(inv_f64_grads(mp, legs)), 'patches')
    del models_
    torch.cuda.empty_cache()
    _, k_ms, p_ms, k_ts, p_ts = time_steps(
        mk, mp, legs, 'bf16', reps, loss=inv_loss, tag='[inv-bf16-train]',
        n_clouds=2 * INV_BATCH)
    del mk, mp
    torch.cuda.empty_cache()
    out.update(kernel_ms=k_ms, plain_ms=p_ms, kernel_runs_ms=k_ts,
               plain_runs_ms=p_ts)
    return out


def phase_inv_bf16_descriptor(device, root, reps=5):
    """[inv-bf16-descriptor] bf16 descriptors at b=48 patches (the serving
    path), kernel path vs plain path: per-patch cosine >= 0.999, or, if the
    kernel path's own noise floor (against itself on the patches scaled by
    1 + 1e-6) lies below that, >= the floor less 0.01; both timed in turns
    (median of 5)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    src, tgt = inv_legs(root, device, items=(0, 1))
    x = torch.cat([src, tgt])[:INV_DESC_BATCH].contiguous()
    model = inv_model(device).eval()

    def plain_fwd():
        with kernels.plain():
            return model(x)[0]
    with torch.no_grad(), compute_dtype('bf16'):
        ones = capture_calls(('ones_conv',), lambda: model(x))
        ones_rows = check_ones_calls('[inv-bf16-descriptor]', ones, 'bf16')
        del ones
        yk, yp = model(x)[0], plain_fwd()
        yq = model(x * (1 + 1e-6))[0]
        torch.cuda.synchronize()
        k_ts, p_ts = [], []
        for _ in range(reps):
            k_ts.append(time_ms(lambda: model(x), reps=1, warmup=0))
            p_ts.append(time_ms(plain_fwd, reps=1, warmup=0))
    k_ms, p_ms = statistics.median(k_ts), statistics.median(p_ts)
    cos, floor = float(_cosine(yk, yp).min()), float(_cosine(yk, yq).min())
    gate, which = (0.999, '0.999') if floor >= 0.999 else \
        (floor - 0.01, f'the noise floor {floor:.6f} - 0.01')
    log(f'[inv-bf16-descriptor] b={INV_DESC_BATCH} bf16 descriptors '
        f'{tuple(yk.shape)} {yk.dtype}: kernel vs plain path min per-patch '
        f'cosine {cos:.6f} (gate {which}); kernel path vs itself on the '
        f'patches x (1 + 1e-6) min {floor:.6f}; norms '
        f'{float(yk.norm(dim=1).min()):.6f}-{float(yk.norm(dim=1).max()):.6f}'
        f'; forward kernel path {k_ms:.2f} ms '
        f'({1e3 * INV_DESC_BATCH / k_ms:.1f} patches/s), plain path '
        f'{p_ms:.2f} ms; median of {reps} turns')
    assert yk.shape == (INV_DESC_BATCH, 64) and yk.dtype == torch.float32
    assert torch.isfinite(yk).all() and cos >= gate, (cos, gate)
    del model
    torch.cuda.empty_cache()
    return {'min_cos': cos, 'noise_min_cos': floor, 'gate': gate,
            'kernel_ms': k_ms, 'plain_ms': p_ms, 'kernel_runs_ms': k_ts,
            'plain_runs_ms': p_ts, 'ones_conv': ones_rows}


# --------------------------------------- reg_so3net (ModelNet rotation)

REG_DIR = os.path.join(ROOT, 'build', 'chip_smoke_reg')
REG_BATCH = 8           # alignment pairs a step: the rotation entry's b
REG_LAYERS = ('B0L0', 'B0L1', 'B1L0', 'B1L1', 'B2L0', 'B2L1', 'B3L0')
# the inter layers with a feature table whose backward composes (c <= 32
# or nn > 32: 32->32 nn 32, 32->64, 64->128 and 128->256 at nn 64) and
# those that keep the fused dTable / dW (64->64, 128->128 at nn 32)
REG_COMPOSED = ('B0L1', 'B1L0', 'B2L0', 'B3L0')
REG_FUSED = ('B1L1', 'B2L1')
# kernel launches of one eval forward of the pair model (2 * b clouds in
# one batch): fps, 7 ball queries, the ones conv at B0L0, the W-fused inter
# conv at the other 6 layers, the intra conv at all 7
REG_EVAL = {**_NO_BF16, **_NO_WOFF, 'fps': 1, 'ball_query': 7,
            'ones_conv': 1, 'inter_conv': 6, 'inter_conv_dtable': 0,
            'inter_conv_dw': 0, 'intra_conv': 7, 'intra_conv_dw': 0}
# one fp32 step: the forward's, then the backward: intra df (the forward
# kernel) and dW at 7, the fused dTable / dW at the 2 fused layers,
# inter_conv_f and inter_conv_dg at the 4 composed ones
REG_PER_STEP = {**REG_EVAL, 'intra_conv': 14, 'intra_conv_dw': 7,
                'inter_conv_dtable': 2, 'inter_conv_dw': 2,
                'inter_conv_f': 4, 'inter_conv_dg': 4}
# bf16: the prenorm intra conv at all 7 layers (the inter InstanceNorm
# deferred into it), moments for the inter and intra InstanceNorm at 7 and
# the packed skip's at 6 (B0L0's rank-1 skip runs unpacked), the grouped
# conv at those 6 skips; in the step their backward too
REG_BF16_EVAL = {**REG_EVAL, 'intra_conv': 0, 'intra_conv_prenorm': 7,
                 'moments': 20, 'grouped_conv': 6}
REG_BF16_PER_STEP = {**REG_PER_STEP, 'intra_conv': 0, 'intra_conv_dw': 0,
                     'intra_conv_prenorm': 7, 'intra_conv_prenorm_df': 7,
                     'intra_conv_prenorm_dw': 7, 'moments': 20,
                     'grouped_conv': 6, 'grouped_conv_bwd': 6}


def _reg_layer(name, i):
    return _step_layer(name, i, REG_LAYERS, REG_COMPOSED, REG_FUSED, ())


def reg_tree():
    """A synthetic ModelNet tree of asymmetric airplanes (the alignment
    loader's category): 16 train and 8 testR clouds of 2048 points."""
    from epn_pointcloud_tpu_torch.data import synthetic
    root = os.path.join(REG_DIR, 'modelnet')
    if not os.path.isdir(root):
        synthetic.make_modelnet_tree(root, n_cats=1, n_train=2 * REG_BATCH,
                                     n_test=REG_BATCH, n_points=2048, seed=0,
                                     splits=('train', 'testR'),
                                     airplane_asym=True)
    return root


def reg_opt(root, mode='train'):
    """The rotation entry point's model options (reg_so3net, quat)."""
    from epn_pointcloud_tpu_torch.app import config
    opt = config.parse_args(['experiment', '-d', root, '--run-mode', mode])
    opt.model.model, opt.model.flag = 'reg_so3net', 'rotation'
    return opt


def reg_batch(root, device, mode='train', opt=None):
    """(pairs [8, 2, 1024, 3], R_label [8, na], T [8, 3, 3], R [8, na, 3,
    3]) on the card: the port's alignment loader's first 8 items (na: the
    options' kanchor, 60 unless ``opt`` names another)."""
    import numpy as np
    import torch
    from epn_pointcloud_tpu_torch.data import modelnet40
    loader = modelnet40.Dataloader_ModelNet40Alignment(
        opt or reg_opt(root, mode), mode)
    data = [loader[i] for i in range(REG_BATCH)]
    return tuple(torch.from_numpy(np.stack([d[k] for d in data])).to(device)
                 for k in ('pc', 'R_label', 'T', 'R'))


def reg_model(device):
    from epn_pointcloud_tpu_torch import models
    return models.build_model_from(reg_opt('unused'), seed=SEED).to(device)


def reg_loss(model, batch):
    """The rotation step's loss: the pair forward, then the multi-task
    detection loss (anchor-pair cross entropy + 10 x the L2 of the
    regressed rotations) in the alignment setting."""
    import torch
    from epn_pointcloud_tpu_torch import losses
    from epn_pointcloud_tpu_torch.ops import icosahedron
    pc, rlabel, T, R = batch
    wts, y = model(pc)
    anchors = torch.from_numpy(icosahedron.get_anchors(60)).to(pc)
    return losses.multi_task_detection_loss(anchors, wts, rlabel, y, R, T,
                                            nr=4)[0]


def reg_f64_max(model, batch, chunk=2, loss=None):
    """Per-leaf max |gradient| of the step (``loss``, reg_loss by default)
    on a float64 copy of ``model`` on the plain path, ``chunk`` pairs at a
    time (the loss is the mean of the pairs' losses, so the chunks'
    gradients, each scaled by its share, add up to the batch's)."""
    import copy
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    m64 = copy.deepcopy(model).double()
    m64.zero_grad(set_to_none=True)
    nb = batch[0].shape[0]
    with kernels.plain():
        for i in range(0, nb, chunk):
            pc, rlabel, T, R = (t[i:i + chunk] for t in batch)
            sub = (pc.double(), rlabel, T.double(), R.double())
            ((loss or reg_loss)(m64, sub) * (pc.shape[0] / nb)).backward()
    out = {n: float(p.grad.abs().max()) if p.grad is not None else 0.0
           for n, p in m64.named_parameters()}
    del m64
    torch.cuda.empty_cache()
    return out


def phase_reg_kernels(device, batch):
    """[reg-kernels] Each kernel call of one fp32 reg step (b=8 pairs: one
    forward of 16 clouds and its backward) against its plain version on
    the same inputs, timed, with phase 12's checks (``check_step_calls``,
    ``check_fp32_step_rows``); the step's launches by kernel printed, every
    one on its CUDA-core kernel (``check_routes``)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    tag = '[reg-kernels]'
    model = reg_model(device).train()
    kernels.reset_counts()
    calls = capture_calls(INV_NAMES, lambda: reg_loss(model, batch).backward())
    counts, routes = kernels.counts(), route_counts()
    del model
    check_routes(tag, 'fp32', counts, routes)
    assert counts == REG_PER_STEP, (counts, REG_PER_STEP)
    torch.set_grad_enabled(False)
    try:
        results, failures, n_calls = check_step_calls(tag, calls, INV_NAMES,
                                                      'fp32', _reg_layer)
    finally:
        torch.set_grad_enabled(True)
    del calls
    expect = {n: REG_PER_STEP.get(n, 0) for n in INV_NAMES}
    expect['intra_conv'] = expect['intra_conv_df'] = 7
    if n_calls != expect:
        failures.append(f'reg step calls {n_calls}, expected {expect}')
    if failures:
        raise AssertionError(f'reg kernel comparisons failed: {failures}')
    check_fp32_step_rows(tag, results, expect, REG_PER_STEP)
    torch.cuda.empty_cache()
    return results, routes


def phase_reg_forward(device, batch, reps=5):
    """[reg-forward] The eval-mode pair forward at b=8 pairs on the kernel
    and the plain path: confidence [8, 60, 60] and y [8, 60, 60, 4] to rtol
    1e-3, atol 2e-3, its launches (REG_EVAL) on their CUDA-core kernels;
    both timed in turns (median of 5)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    pc = batch[0]
    model = reg_model(device).eval()

    def plain_fwd():
        with kernels.plain():
            return model(pc)
    with torch.no_grad():
        kernels.reset_counts()
        ck, yk = model(pc)
        torch.cuda.synchronize()
        counts, routes = kernels.counts(), route_counts()
        cp, yp = plain_fwd()
        torch.cuda.synchronize()
        assert kernels.counts() == counts, 'the plain path launched a kernel'
        k_ts, p_ts = [], []
        for _ in range(reps):
            k_ts.append(time_ms(lambda: model(pc), reps=1, warmup=0))
            p_ts.append(time_ms(plain_fwd, reps=1, warmup=0))
    check_routes('[reg-forward]', 'fp32', counts, routes)
    assert counts == REG_EVAL, (counts, REG_EVAL)
    k_ms, p_ms = statistics.median(k_ts), statistics.median(p_ts)
    errs = (float((ck - cp).abs().max()), float((yk - yp).abs().max()))
    log(f'[reg-forward] b={REG_BATCH} pairs eval confidence '
        f'{tuple(ck.shape)} y {tuple(yk.shape)}: kernel vs plain path '
        f'max_abs_err {errs[0]:.3e} / {errs[1]:.3e} (rtol 1e-3, atol 2e-3); '
        f'forward kernel path {k_ms:.2f} ms '
        f'({1e3 * REG_BATCH / k_ms:.1f} pairs/s), plain path {p_ms:.2f} ms '
        f'({1e3 * REG_BATCH / p_ms:.1f} pairs/s); median of {reps} turns')
    assert ck.shape == (REG_BATCH, 60, 60) and yk.shape == (REG_BATCH, 60,
                                                             60, 4)
    assert torch.isfinite(ck).all() and torch.isfinite(yk).all()
    torch.testing.assert_close(ck, cp, rtol=1e-3, atol=2e-3)
    torch.testing.assert_close(yk, yp, rtol=1e-3, atol=2e-3)
    del model
    torch.cuda.empty_cache()
    return {'max_abs_err': max(errs), 'kernel_ms': k_ms, 'plain_ms': p_ms,
            'pairs_per_s': 1e3 * REG_BATCH / k_ms, 'kernel_runs_ms': k_ts,
            'plain_runs_ms': p_ts}


def phase_reg_train(device, batch, reps=5):
    """[reg-train] One fp32 reg step (b=8 pairs) on the kernel path and on
    the plain path from the same weights: loss to rtol 1e-5, a gradient for
    every parameter on both, per-leaf agreement by the rule of
    tests/test_reference_train_parity.py (degenerate leaves from a float64
    step), the launches REG_PER_STEP on their CUDA-core kernels; the whole
    step timed on both paths in turns (median of 5); 10 Adam steps on one
    batch lower the loss."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    tag = '[reg-train]'
    mk, mp = (reg_model(device).train() for _ in range(2))
    f64 = reg_f64_max(mp, batch)
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    loss_k = reg_loss(mk, batch)
    loss_k.backward()
    torch.cuda.synchronize()
    mem_k = torch.cuda.max_memory_allocated() / 2 ** 30
    counts_k = kernels.counts()
    check_routes(tag, 'fp32', counts_k, route_counts())
    torch.cuda.reset_peak_memory_stats()
    with kernels.plain():
        loss_p = reg_loss(mp, batch)
        loss_p.backward()
    torch.cuda.synchronize()
    mem_p = torch.cuda.max_memory_allocated() / 2 ** 30
    assert kernels.counts() == counts_k, 'the plain path launched a kernel'
    assert counts_k == REG_PER_STEP, (counts_k, REG_PER_STEP)
    lk, lp = loss_k.item(), loss_p.item()
    log(f'{tag} b={REG_BATCH} pairs, loss kernel path {lk:.7f}, plain path '
        f'{lp:.7f} (rtol 1e-5); peak device memory kernel path {mem_k:.2f} '
        f'GiB, plain path {mem_p:.2f} GiB')
    assert math.isfinite(lk) and abs(lk - lp) <= 1e-5 * abs(lp), (lk, lp)
    no_grad = [n for m in (mk, mp) for n, p in m.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    assert not no_grad, f'parameters without a finite gradient: {no_grad}'
    bad, degen, worst = [], [], (0.0, '')
    pk = dict(mk.named_parameters())
    for name, p in mp.named_parameters():
        ok, msg = _grads_close(name, pk[name].grad, p.grad, f64[name])
        if not ok:
            bad.append(msg)
        elif 'degenerate' in msg:
            degen.append(msg)
        if f64[name] > 1e-5:
            worst = max(worst, (rel_err(pk[name].grad, p.grad), name))
    log(f'{tag} gradients: {len(pk)} leaves, every one on both paths, worst '
        f'relative L2 {worst[0]:.3e} at {worst[1]}; {len(degen)} degenerate '
        f'leaves (fp64 gradient <= 1e-5 or both <= 1e-3): '
        f'{"; ".join(degen)}')
    assert not bad, bad
    opt_k, k_ms, p_ms, k_ts, p_ts = time_steps(
        mk, mp, batch, 'fp32', reps, loss=reg_loss, tag=tag,
        n_clouds=2 * REG_BATCH)
    log(f'{tag} whole step: {1e3 * REG_BATCH / k_ms:.1f} pairs/s on the '
        f'kernel path, {1e3 * REG_BATCH / p_ms:.1f} on the plain path')
    del mp
    torch.cuda.empty_cache()
    trace = []
    for i in range(11):
        loss = reg_loss(mk, batch)
        trace.append(loss.item())
        if i < 10:
            opt_k.zero_grad(set_to_none=True)
            loss.backward()
            opt_k.step()
    log(f'{tag} 10 Adam steps on one batch, kernel path: loss '
        f'{trace[0]:.4f} -> {trace[-1]:.4f}')
    assert all(map(math.isfinite, trace)) and trace[-1] < trace[0], trace
    del mk
    torch.cuda.empty_cache()
    return {'loss_kernel': lk, 'loss_plain': lp, 'kernel_ms': k_ms,
            'plain_ms': p_ms, 'kernel_runs_ms': k_ts, 'plain_runs_ms': p_ts,
            'worst_grad_rel_l2': worst[0], 'adam_trace': trace,
            'peak_gib_kernel': mem_k, 'peak_gib_plain': mem_p}


def phase_reg_bf16(device, batch, reps=5):
    """[reg-bf16] The bf16 production mode of the reg model at b=8 pairs.
    The eval pair forward by the rule of [inv-bf16-descriptor]: per-pair
    cosine of confidence and of y, kernel vs plain path, >= 0.999 (or the
    kernel path's noise floor on the clouds x (1 + 1e-6) less 0.01, when
    that lies lower), its launches REG_BF16_EVAL, both timed with peak
    memory; the step by the rule of [inv-bf16-train] (``bf16_step_check``:
    the launches REG_BF16_PER_STEP, loss to rtol 1e-3, every parameter
    with a gradient, the per-leaf cosine and noise-floor rule, every B6 dW
    call within 1e-3 of its plain version on the tensor-core dW), peak
    memory, timed on both paths in turns (median of 5)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    tag = '[reg-bf16]'
    pc = batch[0]
    model = reg_model(device).eval()

    def plain_fwd():
        with kernels.plain():
            return model(pc)
    with torch.no_grad(), compute_dtype('bf16'):
        kernels.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        ck, yk = model(pc)
        torch.cuda.synchronize()
        mem_k = torch.cuda.max_memory_allocated() / 2 ** 30
        counts, routes = kernels.counts(), route_counts()
        torch.cuda.reset_peak_memory_stats()
        cp, yp = plain_fwd()
        torch.cuda.synchronize()
        mem_p = torch.cuda.max_memory_allocated() / 2 ** 30
        cq, yq = model(pc * (1 + 1e-6))
        k_ts, p_ts = [], []
        for _ in range(reps):
            k_ts.append(time_ms(lambda: model(pc), reps=1, warmup=0))
            p_ts.append(time_ms(plain_fwd, reps=1, warmup=0))
    check_routes(tag, 'bf16', counts, routes)
    assert counts == REG_BF16_EVAL, (counts, REG_BF16_EVAL)
    k_ms, p_ms = statistics.median(k_ts), statistics.median(p_ts)
    def pair_cos(a, b):
        return float(_cosine(a.flatten(1), b.flatten(1)).min())
    cos = min(pair_cos(ck, cp), pair_cos(yk, yp))
    floor = min(pair_cos(ck, cq), pair_cos(yk, yq))
    gate, which = (0.999, '0.999') if floor >= 0.999 else \
        (floor - 0.01, f'the noise floor {floor:.6f} - 0.01')
    log(f'{tag} b={REG_BATCH} pairs bf16 eval forward: confidence '
        f'{ck.dtype}, y {yk.dtype}; kernel vs plain path min per-pair cosine '
        f'{cos:.6f} (gate {which}); kernel path vs itself on the clouds x '
        f'(1 + 1e-6) min {floor:.6f}; forward kernel path {k_ms:.2f} ms '
        f'({1e3 * REG_BATCH / k_ms:.1f} pairs/s), plain path {p_ms:.2f} ms; '
        f'median of {reps} turns; peak device memory kernel path '
        f'{mem_k:.2f} GiB, plain path {mem_p:.2f} GiB')
    assert ck.dtype == yk.dtype == torch.float32
    assert torch.isfinite(ck).all() and torch.isfinite(yk).all()
    assert cos >= gate, (cos, gate)
    del model
    torch.cuda.empty_cache()
    models_ = tuple(reg_model(device).train()
                    for _ in range(3 + len(NOISE_SCALES)))
    mk, mp = models_[:2]
    out = bf16_step_check(
        f'{tag} b={REG_BATCH} pairs,', models_, reg_loss, batch,
        [(pc * sc,) + batch[1:] for sc in NOISE_SCALES], REG_BF16_PER_STEP,
        reg_f64_max(mp, batch), 'clouds')
    del models_
    torch.cuda.empty_cache()
    _, sk_ms, sp_ms, sk_ts, sp_ts = time_steps(
        mk, mp, batch, 'bf16', reps, loss=reg_loss, tag=tag,
        n_clouds=2 * REG_BATCH)
    log(f'{tag} whole bf16 step: {1e3 * REG_BATCH / sk_ms:.1f} pairs/s on '
        f'the kernel path, {1e3 * REG_BATCH / sp_ms:.1f} on the plain path')
    del mk, mp
    torch.cuda.empty_cache()
    out.update(forward_min_cos=cos, forward_noise_min_cos=floor,
               forward_gate=gate, forward_kernel_ms=k_ms,
               forward_plain_ms=p_ms, forward_kernel_runs_ms=k_ts,
               forward_plain_runs_ms=p_ts, forward_peak_gib_kernel=mem_k,
               forward_peak_gib_plain=mem_p, kernel_ms=sk_ms, plain_ms=sp_ms,
               kernel_runs_ms=sk_ts, plain_runs_ms=sp_ts)
    return out


class working_dir:
    """The process's working directory inside the block (made if needed):
    the entry points write data/ and trained_models/ under it."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        self.old = os.getcwd()
        os.makedirs(self.path, exist_ok=True)
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def phase_reg_entry(dtype='fp32'):
    """[reg-entry] A main path: run_modelnet_rotation --run-mode train
    --compute-dtype ``dtype`` -i 4 --save-freq 4 on the synthetic airplanes
    (b=8 pairs, the eval of testR at step 4), its launches by kernel
    (4 x the step's plus the eval's, every one on the kernel of its dtype),
    finite Loss, Reg_Loss, Mean_Err and R_Acc, params.json; then the
    checkpoint through --run-mode eval -r in the same dtype: the same
    weights, its launches, and a finite median angular error over the
    per-pair errors it writes under data/alignment_errors/ of its working
    directory (under build/)."""
    import numpy as np
    import torch
    from epn_pointcloud_tpu_torch import run_modelnet_rotation as rot
    from epn_pointcloud_tpu_torch.ops import kernels, so3conv
    tag = f'[reg-entry] {dtype}'
    per_step, per_eval = ((REG_PER_STEP, REG_EVAL) if dtype == 'fp32' else
                          (REG_BF16_PER_STEP, REG_BF16_EVAL))
    steps = 4
    common = ['experiment', '-d', reg_tree(), '--compute-dtype', dtype,
              '--model-dir', os.path.join(REG_DIR, 'runs')]
    cwd = os.path.join(REG_DIR, f'cwd_{dtype}')
    shutil.rmtree(cwd, ignore_errors=True)
    try:
        with working_dir(cwd):
            kernels.reset_counts()
            t0 = time.time()
            trainer = rot.main(common + ['-i', str(steps), '--save-freq',
                                         str(steps), '-lf', '1'])
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts, routes = kernels.counts(), route_counts()
            trainer.logger.close()
            ckpt = trainer.last_ckpt
            kernels.reset_counts()
            t0 = time.time()
            other = rot.main(common + ['--run-mode', 'eval', '-r', ckpt])
            torch.cuda.synchronize()
            eval_wall = time.time() - t0
            eval_counts, eval_routes = kernels.counts(), route_counts()
            other.logger.close()
            errors = np.loadtxt(os.path.join(
                'data', 'alignment_errors',
                f'{other.exp_name}_error.txt')).reshape(-1)
    finally:
        so3conv.set_compute_dtype('fp32')
    stats = dict(trainer.summary.running_stats)
    n_eval = len(trainer.dataset_test)
    median = float(np.median(errors) * 180 / np.pi)
    log(f'{tag} run_modelnet_rotation train --compute-dtype {dtype}: '
        f'{steps} steps of b={trainer.opt.batch_size} pairs, the eval of '
        f'{n_eval} batch(es) at step {steps}; running stats {stats}; wall '
        f'{wall:.2f} s (data and setup included); kernel launches {counts}, '
        f'a step { {n: k for n, k in per_step.items() if k} }')
    check_routes(tag, dtype, counts, routes)
    assert trainer.opt.batch_size == REG_BATCH and n_eval >= 1
    assert all(math.isfinite(stats[k]) for k in ('Loss', 'Reg_Loss',
                                                 'Mean_Err', 'R_Acc'))
    assert math.isfinite(float(trainer.last_loss))
    assert all(p.dtype == torch.float32 and p.grad is not None
               for p in trainer.model.parameters())
    expect = {n: steps * k + n_eval * per_eval[n]
              for n, k in per_step.items()}
    assert counts == expect, (counts, expect)
    with open(os.path.join(trainer.root_dir, 'params.json')) as f:
        assert json.load(f) == trainer.model.params
    for (k, a), (_, b) in zip(trainer.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), k
    n_other = len(other.dataset_test)
    log(f'{tag} checkpoint {os.path.basename(ckpt)} through --run-mode eval '
        f'--compute-dtype {dtype} -r: {errors.shape[0]} pairs, median '
        f'angular error {median:.3f} degrees; wall {eval_wall:.2f} s; kernel '
        f'launches {eval_counts}')
    check_routes(tag, dtype, eval_counts, eval_routes)
    assert eval_counts == {n: n_other * k for n, k in per_eval.items()}
    assert errors.shape == (n_other * REG_BATCH,) and math.isfinite(median)
    return {'train_launches': counts, 'eval_launches': eval_counts,
            'train_wall_s': wall, 'eval_wall_s': eval_wall,
            'median_deg': median, 'running_stats': stats}


# ------------------------------------- 3DMatch descriptor evaluation

EVAL_DIR = os.path.join(ROOT, 'build', 'chip_smoke_3dmatch_eval')
EVAL_SCENE = 'synth-scene'
EVAL_KPTS = 384          # keypoints a fragment: two chunks of 192
EVAL_CHUNK = 192         # the eval chunk: batch_size 8 x npt 24
# kernel launches of one inv descriptor forward (8 layers): fps, 8 ball
# queries, the ones conv, the W-fused inter conv at 7 layers, the intra conv
# at 8; bf16: the prenorm intra conv at 8, moments at 8 + 8 + 7, the
# grouped conv at the 7 packed skips
INV_EVAL = {**_NO_BF16, **_NO_WOFF, 'fps': 1, 'ball_query': 8,
            'ones_conv': 1, 'inter_conv': 7, 'inter_conv_dtable': 0,
            'inter_conv_dw': 0, 'intra_conv': 8, 'intra_conv_dw': 0}
INV_BF16_EVAL = {**INV_EVAL, 'intra_conv': 0, 'intra_conv_prenorm': 8,
                 'moments': 23, 'grouped_conv': 7}
EVAL_NAMES = ('fps', 'ball_query', 'ones_conv', 'inter_conv', 'intra_conv',
              'intra_conv_prenorm', 'moments', 'grouped_conv')


def eval_tree():
    """The dense synthetic 3DMatch room of inv_tree with 384 keypoints a
    fragment (3 fragments, gt.log of the 2 consecutive pairs)."""
    from epn_pointcloud_tpu_torch.data import synthetic
    root = os.path.join(EVAL_DIR, 'data')
    if not os.path.isdir(root):
        synthetic.make_3dmatch_tree(root, scene=EVAL_SCENE, n_frags=3,
                                    n_points=32000, n_kpts=EVAL_KPTS,
                                    seed=11, extent=(2.0, 2.0, 1.6),
                                    kpt_margin=0.45)
    return root


def check_chunk_calls(tag, model, x, dtype):
    """Every kernel call of one descriptor forward of the chunk x [192,
    1024, 3] against its plain version on the same inputs (no timing):
    fps and ball_query indices equal, the others normwise within 1e-5
    (fp32) or 8e-3 / 1e-3 (bf16 / fp32 outputs in bf16 mode); the card
    check of every kernel at the eval chunk's batch."""
    import torch
    with torch.no_grad(), compute_dtype(dtype):
        calls = capture_calls(EVAL_NAMES, lambda: model(x))
        worst, bad = {}, []
        for name, args in calls:
            kern_fn, plain_fn, pargs = _kernel_pair(name, args)
            got, want = kern_fn(*args), plain_fn(*pargs)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            rels, ok = compare_outputs(got, want, train_tol(name, dtype))
            worst[name] = max(worst.get(name, 0.0), *rels)
            if not ok:
                bad.append(f'{name} {tuple(args[0].shape)}: {rels}')
            del got, want
    n = {k: sum(1 for c in calls if c[0] == k) for k in worst}
    del calls
    torch.cuda.empty_cache()
    log(f'{tag} every kernel call of one b={x.shape[0]} {dtype} chunk '
        f'against its plain version: calls {n}, worst error (index '
        f'difference, else normwise) {worst}')
    assert not bad, bad
    return {'calls': n, 'worst': worst}


def phase_3dmatch_eval_entry(ckpt, dtype='fp32'):
    """[3dmatch-eval-entry] A main path: run_3dmatch --run-mode eval -r
    CKPT --compute-dtype ``dtype`` on a synthetic scene of 3 fragments of
    384 keypoints (two chunks of 192 patches each), working directory
    under build/: the features of each fragment [384, 64] finite,
    recall.txt and recall.csv written, the launches 6 x one descriptor
    forward's on the kernels of the dtype; every kernel call of one chunk
    held to its plain version (``check_chunk_calls``), and the chunk's
    descriptors on the kernel path against the plain path (fp32 rtol 1e-3,
    atol 2e-3; bf16 per-patch cosine >= 0.999); the host seconds (patch
    search and loading, matching) beside the forward's and the device's."""
    import numpy as np
    import torch
    from epn_pointcloud_tpu_torch import run_3dmatch
    from epn_pointcloud_tpu_torch.ops import kernels, so3conv
    tag = f'[3dmatch-eval-entry] {dtype}'
    root = eval_tree()
    exp = f'inv_{dtype}'
    cwd = os.path.join(EVAL_DIR, f'cwd_{dtype}')
    shutil.rmtree(cwd, ignore_errors=True)
    # -r <dir>/<dir>/<experiment>/...: the entry's experiment id
    rel = os.path.join('trained_models', 'models', exp, 'ckpt',
                       os.path.basename(ckpt))
    os.makedirs(os.path.dirname(os.path.join(cwd, rel)))
    shutil.copy(ckpt, os.path.join(cwd, rel))
    per_chunk = INV_EVAL if dtype == 'fp32' else INV_BF16_EVAL
    try:
        with working_dir(cwd):
            kernels.reset_counts()
            t0 = time.time()
            trainer = run_3dmatch.main(
                ['experiment', '-d', root, '--run-mode', 'eval', '-r', rel,
                 '--compute-dtype', dtype, '--model-dir', 'runs'],
                scenes=[EVAL_SCENE])
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts, routes = kernels.counts(), route_counts()
            trainer.logger.close()
            feat_dir = os.path.join('data', 'evaluate', '3DMatch', exp,
                                    EVAL_SCENE, '32_dim')
            feats = [np.load(os.path.join(feat_dir, f'feature{i}.npy'))
                     for i in range(3)]
            recall_txt = os.path.exists(os.path.join(feat_dir, 'recall.txt'))
            with open(os.path.join('trained_models', 'evaluate', '3DMatch',
                                   exp, 'recall.csv')) as f:
                recall_csv = f.read()
        s = dict(trainer.eval_seconds)
        n_chunks = 3 * -(-EVAL_KPTS // EVAL_CHUNK)
        log(f'{tag} run_3dmatch eval -r {rel} --compute-dtype {dtype}: '
            f'chunk {trainer.opt.batch_size} x {trainer.opt.npt} patches, '
            f'{s["patches"]} patches in {n_chunks} forwards; features '
            f'{[f.shape for f in feats]}; recall.csv {recall_csv!r}; wall '
            f'{wall:.2f} s (setup included): host patch search and loading '
            f'{s["load_s"]:.3f} s, forward {s["forward_s"]:.3f} s '
            f'({s["patches"] / s["forward_s"]:.1f} patches/s; device '
            f'{s["device_s"]:.3f} s by CUDA events), host matching '
            f'{s["match_s"]:.3f} s; kernel launches {counts}')
        check_routes(tag, dtype, counts, routes)
        assert trainer.opt.batch_size * trainer.opt.npt == EVAL_CHUNK
        assert s['patches'] == 3 * EVAL_KPTS
        assert counts == {n: n_chunks * k for n, k in per_chunk.items()}, \
            (counts, per_chunk)
        assert all(f.shape == (EVAL_KPTS, 64) and np.isfinite(f).all()
                   for f in feats)
        assert recall_txt and recall_csv.startswith('Scene,tau_0.05') and \
            EVAL_SCENE in recall_csv
        cache = os.path.join(root, EVAL_SCENE, 'grouped_data_r0.40',
                             'grouped_cloud_bin_0.npz')
        x = torch.from_numpy(np.load(cache)['arr_0'][:EVAL_CHUNK]).to(
            trainer.device)
        model = trainer.model.eval()
        chunk = check_chunk_calls(tag, model, x, dtype)

        def plain_fwd():
            with kernels.plain():
                return model(x)[0]
        with torch.no_grad(), compute_dtype(dtype):
            yk, yp = model(x)[0], plain_fwd()
        saved = float((yk.cpu() - torch.from_numpy(
            feats[0][:EVAL_CHUNK])).abs().max())
        assert saved <= 1e-5, saved
        if dtype == 'fp32':
            err = float((yk - yp).abs().max())
            torch.testing.assert_close(yk, yp, rtol=1e-3, atol=2e-3)
            note = f'max_abs_err {err:.3e} (rtol 1e-3, atol 2e-3)'
        else:
            err = float(_cosine(yk, yp).min())
            assert err >= 0.999, err
            note = f'min per-patch cosine {err:.6f} (>= 0.999)'
        log(f'{tag} chunk of {EVAL_CHUNK} patches, kernel vs plain path '
            f'descriptors: {note}; the kernel path against the saved '
            f'features: max_abs_err {saved:.3e} (<= 1e-5)')
        del model, trainer, x, yk, yp
    finally:
        so3conv.set_compute_dtype('fp32')
    torch.cuda.empty_cache()
    return {'launches': counts, 'wall_s': wall, 'seconds': s,
            'chunk_err': err, 'chunk_calls': chunk, 'recall_csv': recall_csv}


# the fp32 CUDA-core kernels of the inter forward and backward and the
# intra forward, df and dW, by wrapper: the kernel and its route (``inter_conv.routes``,
# ``intra_conv.routes``) in the kernels summary
F32_KERNELS = {
    'inter_conv': {'kernel': 'inter_fwd_f32_kernel', 'route': 'fwd_f32'},
    'intra_conv': {'kernel': 'intra_fwd_f32_kernel', 'route': 'fwd_f32'},
    'inter_conv_dw': {'kernel': 'inter_dw_f32_kernel', 'route': 'dw_f32'},
    'intra_conv_dw': {'kernel': 'intra_dw_f32_kernel', 'route': 'dw_f32'},
    'inter_conv_dtable': {'kernel': 'inter_bwd_f32_kernel',
                          'route': 'dtable_f32'},
    'inter_conv_dg': {'kernel': 'inter_bwd_f32_kernel', 'route': 'dg_f32'},
    'inter_conv_f': {'kernel': 'inter_f_f32_kernel', 'route': 'f_f32'}}

# the earlier tree's sources built alone (--parent-csrc): source -> its C
# entries, as PARENT's keys
# ------------------------- the reference convention and reduced anchors

# the reduced-anchor cls models: (kanchor, kpconv); kpconv runs one anchor
ANCHOR_MODELS = {'[ka20]': (20, False), '[ka40]': (40, False),
                 '[kpconv]': (60, True)}
# the kernels a cls forward or step may call (an inter block model calls no
# intra conv and no fused tail: it has no skip branch)
ALL_FWD = ('fps', 'ball_query', 'ones_conv', 'inter_conv', 'intra_conv',
           'intra_conv_prenorm', 'moments', 'grouped_conv_tail',
           'grouped_conv')
ALL_STEP = ALL_FWD + ('inter_conv_dtable', 'inter_conv_dw', 'intra_conv_dw',
                      'intra_conv_prenorm_df', 'intra_conv_prenorm_dw',
                      'grouped_conv_bwd', 'inter_conv_f', 'inter_conv_dg')
# launches of an inter block cls model (7 inter layers, the first on the
# ones input): an fp32 eval forward, and an fp32 train step (dTable and dW
# at the 6 layers with a feature table); bf16 adds the head's grouped mlp
# conv where the JAX package packs (kanchor > 1)
ANCHOR_EVAL = {**_NO_BF16, **_NO_WOFF, 'fps': 1, 'ball_query': 7,
               'ones_conv': 1, 'inter_conv': 6, 'inter_conv_dtable': 0,
               'inter_conv_dw': 0, 'intra_conv': 0, 'intra_conv_dw': 0}
ANCHOR_STEP = {**ANCHOR_EVAL, 'inter_conv_dtable': 6, 'inter_conv_dw': 6}
# the routes of an inter block model's inter calls: the fp32 forward,
# dTable and dW off their redesigned kernels' 60 anchors (the templates);
# the bf16 forward on the tensor-core kernel from MMA_MIN_NA anchors
ANCHOR_ROUTE = {'fp32': 'sgemm', 'bf16': 'mma', 'bf16_na1': 'sgemm',
                'inter_conv_dtable': 'dtable', 'inter_conv_dw': 'dw'}


def anchor_opt(kanchor, kpconv, dataset_path='unused'):
    opt = full_opt(dataset_path)
    opt.model.kanchor, opt.model.kpconv = kanchor, kpconv
    return opt


def check_calls(tag, calls, names, dtype, step=False, routes=REDESIGNED):
    """``check_step_calls`` over the captured calls of one cls forward (the
    bounds of ``fwd_tol``) or train step (``step``: ``train_tol``) in
    ``dtype``, a call's layer its count ('#i'), ``routes`` the kernels a
    row may have run; in bf16 without fps and the ball query, which take
    the fp32 forward's coordinates (``BF16_COMPARED``). Raises if a call
    fails; returns {kernel: rows}."""
    if dtype == 'bf16':
        calls = [c for c in calls if c[0] not in ('fps', 'ball_query')]
    results, failures, _ = check_step_calls(
        tag, calls, names, dtype, layer_of=lambda name, i: f'#{i}',
        tol=train_tol if step else fwd_tol, routes=routes)
    assert not failures, f'{tag} kernel comparisons failed: {failures}'
    return {n: rows for n, rows in results.items() if rows}


def _call_counts(calls):
    out = {}
    for name, _ in calls:
        out[name] = out.get(name, 0) + 1
    return out


def forward_calls(model, x, dtype, names=ALL_FWD):
    """The calls of the kernels ``names`` in one eval forward of ``model``
    on ``x`` in ``dtype`` (captured as they run), and the logits."""
    import torch
    out = []

    def run():
        with torch.no_grad():
            out.append(model(x)[0])
    with compute_dtype(dtype):
        calls = capture_calls(names, run)
    return calls, out[0]


def _route_table(calls_routes):
    """{kernel: {route: calls}} of compared rows."""
    table = {}
    for name, rows in calls_routes.items():
        for r in rows:
            if r.get('route') is not None:
                t = table.setdefault(name, {})
                t[r['route']] = t.get(r['route'], 0) + 1
    return table


def forward_wall(model, x, dtype, reps=3):
    """Whole-forward ms (median of ``reps``, CUDA events) of the kernel and
    the plain path in turns."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels

    def plain_fwd():
        with kernels.plain():
            model(x)
    k_ts, p_ts = [], []
    with torch.no_grad(), compute_dtype(dtype):
        model(x)
        plain_fwd()
        for _ in range(reps):
            k_ts.append(time_ms(lambda: model(x), reps=1, warmup=0))
            p_ts.append(time_ms(plain_fwd, reps=1, warmup=0))
    return statistics.median(k_ts), statistics.median(p_ts)


class plain_at_rounding_points:
    """The plain path (``kernels.plain()``) with the inter forward at the
    TPU kernel's bf16 rounding points (``inter_conv_mma_plain``, which each
    bf16 inter call is held to within 1e-3) in place of
    ``inter_conv_plain`` (fp32 inside): the whole-model reference of the
    bf16 kernel path."""

    def __enter__(self):
        from epn_pointcloud_tpu_torch.ops import kernels
        self.ic = kernels.inter_conv
        self.saved = self.ic.inter_conv_plain
        self.ic.inter_conv_plain = self.ic.inter_conv_mma_plain
        self.plain = kernels.plain()
        self.plain.__enter__()

    def __exit__(self, *exc):
        self.plain.__exit__(*exc)
        self.ic.inter_conv_plain = self.saved


def model_forward_checks(tag, model, device, b32, bf16_vs_fp32=0.999):
    """b=8 logits kernel vs plain path (fp32 to rtol 1e-3, atol 2e-3; bf16
    per-sample cosine >= 0.999); at b=32 the bf16 kernel path against the
    plain path at the kernel's rounding points (``plain_at_rounding_points``:
    per-sample cosine >= 0.999, or >= that reference's own cosine to the
    fp32 plain path where it is lower), the bf16 vs fp32 kernel paths (>=
    ``bf16_vs_fp32``); printed beside them the bf16 kernel path against the
    plain path (fp32 inside its inter forward), both plain paths against
    fp32, and the noise floor (the kernel path on the clouds scaled by
    NOISE_SCALES against on the clouds); the b=32 forward timed in both
    dtypes."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x8 = torch.from_numpy(synthetic_batch(8, N_POINTS, SEED + 1)).to(device)
    out = {}
    with torch.no_grad():
        k8 = model(x8)[0]
        with kernels.plain():
            p8 = model(x8)[0]
        torch.testing.assert_close(k8, p8, rtol=1e-3, atol=2e-3)
        with compute_dtype('bf16'):
            k16 = model(x8)[0]
            with kernels.plain():
                p16 = model(x8)[0]
                p16_32 = model(b32)[0]
            with plain_at_rounding_points():
                r16_32 = model(b32)[0]
            b16 = model(b32)[0]
            # the noise floor: the kernel path on the clouds scaled by
            # 1 +- 1e-6 (bf16 roundings that flip)
            noise = min(float(_cosine(model(b32 * sc)[0], b16).min())
                        for sc in NOISE_SCALES)
        f32 = model(b32)[0]
        with kernels.plain():
            pf32 = model(b32)[0]
    cos8, cos32 = _cosine(k16, p16), _cosine(b16, f32)
    out.update(fp32_b8_max_abs_err=float((k8 - p8).abs().max()),
               bf16_b8_min_cos=float(cos8.min()),
               bf16_b32_vs_rounding_min_cos=float(
                   _cosine(b16, r16_32).min()),
               bf16_b32_vs_plain_min_cos=float(_cosine(b16, p16_32).min()),
               bf16_b32_noise_min_cos=noise,
               bf16_vs_fp32_b32_min_cos=float(cos32.min()),
               rounding_bf16_vs_fp32_b32_min_cos=float(
                   _cosine(r16_32, pf32).min()),
               plain_bf16_vs_fp32_b32_min_cos=float(
                   _cosine(p16_32, pf32).min()))
    del p16_32, r16_32, pf32
    assert torch.isfinite(k8).all() and torch.isfinite(b16).all()
    assert out['bf16_b8_min_cos'] >= 0.999, out
    # the kernel path no further from its reference than that reference is
    # from fp32 (the rounding points' own error), or 0.999
    assert out['bf16_b32_vs_rounding_min_cos'] >= min(
        0.999, out['rounding_bf16_vs_fp32_b32_min_cos']), out
    assert out['bf16_vs_fp32_b32_min_cos'] >= bf16_vs_fp32, out
    for dtype in ('fp32', 'bf16'):
        k_ms, p_ms = forward_wall(model, b32, dtype)
        out[f'{dtype}_forward_b32_ms'] = k_ms
        out[f'{dtype}_plain_forward_b32_ms'] = p_ms
    log(f'{tag} b=8 fp32 logits kernel vs plain path max_abs_err '
        f'{out["fp32_b8_max_abs_err"]:.3e} (rtol 1e-3, atol 2e-3); bf16 '
        f'kernel vs plain min cosine b=8 {out["bf16_b8_min_cos"]:.7f} (>= '
        f'0.999); b=32 bf16 kernel path vs the plain path at its rounding '
        f'points {out["bf16_b32_vs_rounding_min_cos"]:.7f} (>= the lower of '
        f'0.999 and the next reading), vs the plain path '
        f'{out["bf16_b32_vs_plain_min_cos"]:.7f}, the kernel path on the '
        f'clouds x {NOISE_SCALES} vs on the clouds (the noise floor) '
        f'{noise:.7f}; b=32 bf16 '
        f'vs fp32: kernel path {out["bf16_vs_fp32_b32_min_cos"]:.7f} (>= '
        f'{bf16_vs_fp32}), plain path at the rounding points '
        f'{out["rounding_bf16_vs_fp32_b32_min_cos"]:.7f}, plain path '
        f'{out["plain_bf16_vs_fp32_b32_min_cos"]:.7f}; whole '
        f'b={BATCH} forward fp32 {out["fp32_forward_b32_ms"]:.2f} ms '
        f'({1e3 * BATCH / out["fp32_forward_b32_ms"]:.1f} clouds/s; plain '
        f'{out["fp32_plain_forward_b32_ms"]:.2f}), bf16 '
        f'{out["bf16_forward_b32_ms"]:.2f} ms '
        f'({1e3 * BATCH / out["bf16_forward_b32_ms"]:.1f} clouds/s; plain '
        f'{out["bf16_plain_forward_b32_ms"]:.2f})')
    return out


def phase_anchor_model(tag, device):
    """cls_so3net_pn at a reduced anchor count (``ANCHOR_MODELS[tag]``),
    1024 points, full width, seeded: each kernel call of a b=32 forward in
    fp32 and in bf16 and of a b=12 fp32 train step against its plain
    version (``check_calls``), the inter calls' routes (which took the
    template) printed and held to ``ANCHOR_ROUTE``, the model's checks
    (``model_forward_checks``), and the train step kernel vs plain path
    from the same weights (loss to rtol 1e-5, the rotation CE relabelled
    into the subset; per-leaf gradients by ``_grads_close``), timed."""
    import torch
    from epn_pointcloud_tpu_torch import models
    from epn_pointcloud_tpu_torch.ops import kernels
    kanchor, kpconv = ANCHOR_MODELS[tag]
    na = 1 if kpconv else kanchor
    opt = anchor_opt(kanchor, kpconv)
    model = models.build_model_from(opt, seed=SEED).to(device).eval()
    assert model.params['na'] == na
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(device)
    out = {'na': na, 'results': {}}
    for dtype in ('fp32', 'bf16'):
        calls, logits = forward_calls(model, x, dtype)
        assert torch.isfinite(logits).all() and logits.shape == (BATCH, 40)
        expect = {n: k for n, k in ANCHOR_EVAL.items() if k}
        if dtype == 'bf16' and na > 1:
            expect['grouped_conv'] = 1
        assert _call_counts(calls) == expect, (_call_counts(calls), expect)
        with compute_dtype(dtype), torch.no_grad():
            rows = check_calls(f'{tag} {dtype}', calls, ALL_FWD, dtype,
                               routes=REDESIGNED + TEMPLATES)
        routes = _route_table(rows)
        want = ANCHOR_ROUTE['bf16_na1' if dtype == 'bf16' and na == 1
                            else dtype]
        log(f'{tag} {dtype} b={BATCH} forward: launches by kernel {routes} '
            f'(the inter forward on {want!r} at all {expect["inter_conv"]} '
            f'layers)')
        assert routes['inter_conv'] == {want: expect['inter_conv']}, routes
        out['results'][dtype] = rows
        out[f'{dtype}_routes'] = routes
        del calls
        torch.cuda.empty_cache()
    # below 60 anchors the bf16 logits sit further from fp32: at kanchor 20
    # the kernel path reads 0.995, the plain path at its rounding points
    # 0.9965, and a 1e-6 scaling of the clouds moves the kernel path's
    # logits to 0.994 (the noise floor; PERF.md section 6)
    out.update(model_forward_checks(tag, model, device, x,
                                    bf16_vs_fp32=0.99))
    del model, x
    torch.cuda.empty_cache()

    mk, mp = (perturb_norm_biases(models.build_model_from(
        opt, seed=SEED)).to(device).train() for _ in range(2))
    batch = train_batch(device, SEED + 4)
    f64 = f64_grad_max(mp, batch)
    kernels.reset_counts()
    losses_k = []

    def step():
        loss = step_loss(mk, batch)
        loss.backward()
        losses_k.append(loss.item())
    calls = capture_calls(ALL_STEP, step)
    counts_k = kernels.counts()
    with kernels.plain():
        loss_p = step_loss(mp, batch)
        loss_p.backward()
    torch.cuda.synchronize()
    assert kernels.counts() == counts_k, 'the plain path launched a kernel'
    assert counts_k == ANCHOR_STEP, (counts_k, ANCHOR_STEP)
    lk, lp = losses_k[0], loss_p.item()
    assert abs(lk - lp) <= 1e-5 * abs(lp), (lk, lp)
    bad, worst = [], (0.0, '')
    pk = dict(mk.named_parameters())
    for name, p in mp.named_parameters():
        zero = torch.zeros_like(p)
        g = pk[name].grad
        ok, msg = _grads_close(name, zero if g is None else g,
                               zero if p.grad is None else p.grad, f64[name])
        if not ok:
            bad.append(msg)
        if f64[name] > 1e-5 and g is not None:
            worst = max(worst, (float((g - p.grad).norm()
                                      / p.grad.norm().clamp(min=1e-30)),
                                name))
    assert not bad, bad
    log(f'{tag} b={TRAIN_BATCH} fp32 train step: loss kernel path {lk:.7f}, '
        f'plain path {lp:.7f} (rtol 1e-5); {len(pk)} leaves, worst relative '
        f'L2 {worst[0]:.3e} at {worst[1]}')
    with torch.no_grad():
        rows = check_calls(f'{tag} step', calls, ALL_STEP, 'fp32', step=True,
                           routes=REDESIGNED + TEMPLATES)
    routes = _route_table(rows)
    log(f'{tag} fp32 train step: launches by kernel {routes}')
    for name in ('inter_conv_dtable', 'inter_conv_dw'):
        assert routes[name] == {ANCHOR_ROUTE[name]: ANCHOR_STEP[name]}, routes
    assert routes['inter_conv'] == {'sgemm': ANCHOR_STEP['inter_conv']}
    out['results']['step'] = rows
    out['step_routes'] = routes
    del calls
    _, k_ms, p_ms, _, _ = time_steps(mk, mp, batch, 'fp32', 3, tag=tag)
    out.update(loss_kernel=lk, loss_plain=lp, worst_grad_rel_l2=worst[0],
               step_ms=k_ms, plain_step_ms=p_ms)
    del mk, mp
    torch.cuda.empty_cache()
    return out


def short_queries(query, support, radius, n_sample):
    """Queries with exactly n_sample - 1 hits (d^2 < r^2 as the ball query
    computes it): the ones the reference fill leaves a 0 in."""
    from epn_pointcloud_tpu_torch.ops.kernels import ball_query as bq
    diff = query[:, :, None, :] - support[:, None, :, :]
    dx, dy, dz = diff.unbind(-1)
    hits = (((dx * dx + dy * dy) + dz * dz) < bq._r2_f32(radius)).sum(-1)
    return int((hits == n_sample - 1).sum())


def ref_fill_cloud(device, n_sample, b=4, m=64, seed=5, radius=0.2):
    """Queries far apart, each with a planted number of support points
    inside ``radius`` (0, 1, n_sample - 1, n_sample, n_sample + 3 in turn),
    the rest of the support far away, in a shuffled index order."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    plan = [0, 1, n_sample - 1, n_sample, n_sample + 3]
    hits = [plan[j % len(plan)] for j in range(m)]
    n = sum(hits) + 64
    q = np.zeros((b, m, 3), np.float32)
    q[:, :, 0] = 10.0 * np.arange(m)
    s = 1000.0 + rng.rand(b, n, 3).astype(np.float32)
    for bi in range(b):
        slots, used = rng.permutation(n), 0
        for j, h in enumerate(hits):
            off = rng.randn(h, 3)
            off *= 0.5 * radius * rng.rand(h, 1) / np.linalg.norm(
                off, axis=1, keepdims=True)
            s[bi, slots[used:used + h]] = q[bi, j] + off
            used += h
    return (torch.from_numpy(q).to(device), torch.from_numpy(s).to(device),
            radius)


def phase_ref_convention(device):
    """cls_so3net_pn at 60 anchors, 1024 points, under the reference anchor
    convention, on an original-EPN-layout state_dict made from a seed and
    loaded by ``load_reference_state_dict``: each kernel call of a b=32
    forward in fp32 and in bf16 against its plain version
    (``check_calls``; every ball query with the reference fill), the
    model's checks (``model_forward_checks``); then the ball query with the
    reference fill index-equal to plain on both kernels ('warp' and
    'thread') on clouds with planted queries of exactly n_sample - 1 hits
    (their count printed, and the model's own)."""
    import torch
    from epn_pointcloud_tpu_torch import compat, models
    from epn_pointcloud_tpu_torch.ops import icosahedron, kernels
    icosahedron.set_convention('reference')
    try:
        src = models.build_model_from(full_opt(), seed=SEED + 7)
        sd = perturb_norm_biases(src).state_dict()
        gen = torch.Generator().manual_seed(SEED + 8)
        for k, v in sd.items():
            if k.endswith('running_mean'):
                v.copy_(0.1 * torch.randn(v.shape, generator=gen))
            elif k.endswith('running_var'):
                v.copy_(0.5 + torch.rand(v.shape, generator=gen))
        model = models.build_model_from(full_opt(), seed=None)
        compat.load_reference_state_dict(model, sd)
        model = model.to(device).eval()
        x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(
            device)
        out = {'results': {}}
        for dtype in ('fp32', 'bf16'):
            calls, logits = forward_calls(model, x, dtype)
            assert torch.isfinite(logits).all()
            bq = [a for n, a in calls if n == 'ball_query']
            assert bq and all(a[4] is True for a in bq), 'no reference fill'
            short = sum(short_queries(*a[:4]) for a in bq)
            with compute_dtype(dtype), torch.no_grad():
                rows = check_calls(f'[ref-convention] {dtype}', calls,
                                   ALL_FWD, dtype)
            out['results'][dtype] = rows
            out[f'{dtype}_routes'] = _route_table(rows)
            out['model_short_queries'] = short
            log(f'[ref-convention] {dtype} b={BATCH} forward: launches by '
                f'kernel {out[f"{dtype}_routes"]}; {short} of its ball '
                f'queries have exactly n_sample - 1 hits')
            del calls
        out.update(model_forward_checks('[ref-convention]', model, device,
                                        x))
        del model, x
        torch.cuda.empty_cache()
        fills = []
        for ns in (16, 300):
            q, s, r = ref_fill_cloud(device, ns)
            short = short_queries(q, s, r, ns)
            before = dict(kernels.ball_query.routes)
            got = kernels.ball_query.ball_query(q, s, r, ns, True)
            torch.cuda.synchronize()
            route = next(k for k, n in kernels.ball_query.routes.items()
                         if n > before[k])
            want = kernels.ball_query.ball_query_plain(q, s, r, ns, True)
            native = kernels.ball_query.ball_query(q, s, r, ns, False)
            equal = torch.equal(got, want)
            moved = int((got != native).any(-1).sum())
            log(f'[ref-convention] ball_query ref fill ns={ns} route={route}: '
                f'{short} queries with exactly ns - 1 hits, index-equal to '
                f'plain {equal}; {moved} queries differ from the native fill '
                f'(those whose first hit is not point 0)')
            assert equal and 0 < moved <= short, (equal, short, moved)
            assert route == ('warp' if ns <= 256 else 'thread'), route
            fills.append({'n_sample': ns, 'route': route,
                          'short_queries': short, 'equal': equal})
        out['ref_fill'] = fills
        return out
    finally:
        icosahedron.set_convention('native')


def phase_anchor_entry():
    """This slice's main path: run_modelnet --kanchor 20 train -i 2 (b=12
    forced), then its checkpoint through --run-mode eval -r -b 32, each
    kernel's launches counted from 0 before each run and held to the
    per-step / per-batch counts, every inter forward, dTable and dW on the
    route ``ANCHOR_ROUTE`` names."""
    import torch
    from epn_pointcloud_tpu_torch import run_modelnet
    from epn_pointcloud_tpu_torch.data import synthetic
    from epn_pointcloud_tpu_torch.ops import kernels
    tag = '[ka20-entry]'
    tree = os.path.join(WORK_DIR, 'modelnet')
    runs = os.path.join(WORK_DIR, 'runs')
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    synthetic.make_modelnet_tree(tree, n_cats=4, n_train=6, n_test=16,
                                 n_points=N_POINTS, seed=0,
                                 splits=('train', 'testR'))
    common = ['--kanchor', '20', '--model-dir', runs]
    steps = 2
    kernels.reset_counts()
    trainer = run_modelnet.main(['experiment', '-d', tree, '--run-mode',
                                 'train', '-i', str(steps), '--save-freq',
                                 str(steps), '-lf', '1'] + common)
    torch.cuda.synchronize()
    train_counts, train_routes = kernels.counts(), route_counts()
    trainer.logger.close()
    n_eval = len(trainer.eval_logits)
    stats = dict(trainer.summary.running_stats)
    assert trainer.model.params['na'] == 20
    assert all(math.isfinite(stats[k]) for k in ('Loss', 'R_Loss'))
    expect = {n: steps * ANCHOR_STEP[n] + n_eval * ANCHOR_EVAL[n]
              for n in ANCHOR_STEP}
    assert n_eval >= 1 and train_counts == expect, (train_counts, expect)
    log(f'{tag} run_modelnet --kanchor 20 train -i {steps}: running stats '
        f'{stats}; kernel launches {train_counts}; by kernel {train_routes}')
    kernels.reset_counts()
    other = run_modelnet.main(['experiment', '-d', tree, '--run-mode', 'eval',
                               '-b', str(BATCH), '-r', trainer.last_ckpt]
                              + common)
    torch.cuda.synchronize()
    eval_counts, eval_routes = kernels.counts(), route_counts()
    other.logger.close()
    n_batches = len(other.eval_logits)
    logits = torch.cat(other.eval_logits)
    assert torch.isfinite(logits).all() and n_batches >= 2
    expect = {n: n_batches * k for n, k in ANCHOR_EVAL.items()}
    assert eval_counts == expect, (eval_counts, expect)
    for routes, n_fwd, n_bwd in ((train_routes, train_counts['inter_conv'],
                                  train_counts['inter_conv_dw']),
                                 (eval_routes, eval_counts['inter_conv'], 0)):
        inter = {k: v for k, v in routes['inter'].items() if v}
        want = {'sgemm': n_fwd}
        if n_bwd:
            want.update(dtable=n_bwd, dw=n_bwd)
        assert inter == want, (inter, want)
        assert routes['ball_query'] == {'warp': routes['ball_query']['warp'],
                                        'thread': 0}
    log(f'{tag} run_modelnet --kanchor 20 --run-mode eval -r -b {BATCH}: '
        f'{n_batches} batches, logits {tuple(logits.shape)}, accuracy '
        f'{other.test_accs[-1]:.2f}%; kernel launches {eval_counts}; by '
        f'kernel {eval_routes}')
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return {'train_launches': train_counts, 'eval_launches': eval_counts}


# ------------- inv and reg below 60 anchors, the bf16 step below 60 anchors,
# ------------- dropout, and the entry points' last options

# the reduced-anchor inv and reg models: (model, kanchor, kpconv)
ANCHOR_INV_REG = {'[inv-ka20]': ('inv', 20, False),
                  '[inv-ka40]': ('inv', 40, False),
                  '[inv-kpconv]': ('inv', 60, True),
                  '[reg-ka20]': ('reg', 20, False),
                  '[reg-ka40]': ('reg', 40, False),
                  '[reg-kpconv]': ('reg', 60, True)}
# below 60 anchors every kernel of the inter conv runs its template: the
# fp32 (and one-anchor bf16) forward 'sgemm', the dTable 'dtable', the dW
# 'dw', the W-off F 'f' and dG 'dg'; the bf16 forward the tensor-core
# kernel ('mma') from MMA_MIN_NA anchors
BELOW_60_ROUTES = REDESIGNED + TEMPLATES + ('f', 'dg')
# launches of one inter block inv forward (8 layers: the ones conv at B0L0,
# the W-fused inter conv at the 7 others) and reg forward (7 layers; both
# clouds of each pair in one batch); in bf16 at more than one anchor each
# layer's InstanceNorm takes its statistics from the moments kernel (one
# anchor: plain torch sums, the JAX package's unpacked layout)
INV_A_EVAL = {**_NO_BF16, **_NO_WOFF, 'fps': 1, 'ball_query': 8,
              'ones_conv': 1, 'inter_conv': 7, 'inter_conv_dtable': 0,
              'inter_conv_dw': 0, 'intra_conv': 0, 'intra_conv_dw': 0}
REG_A_EVAL = {**INV_A_EVAL, 'ball_query': 7, 'inter_conv': 6}
# one step: the inv triplet step's two legs, reg's one pair forward; the
# backward composes at the same layers as at 60 anchors (c <= 32 or nn >
# 32: INV_COMPOSED, REG_COMPOSED), the others keep the fused dTable / dW
INV_A_STEP = {**INV_A_EVAL, 'fps': 2, 'ball_query': 16, 'ones_conv': 2,
              'inter_conv': 14, 'inter_conv_dtable': 6, 'inter_conv_dw': 6,
              'inter_conv_f': 8, 'inter_conv_dg': 8}
REG_A_STEP = {**REG_A_EVAL, 'inter_conv_dtable': 2, 'inter_conv_dw': 2,
              'inter_conv_f': 4, 'inter_conv_dg': 4}
A_EVAL = {'inv': INV_A_EVAL, 'reg': REG_A_EVAL}
A_STEP = {'inv': INV_A_STEP, 'reg': REG_A_STEP}
# a bf16 cls step at kanchor 20 (7 inter block layers, the head's packed
# mlp): the moments of the 7 inter BatchNorms and the head's, the head's
# grouped conv forward and backward
ANCHOR_BF16_STEP = {**ANCHOR_STEP, 'moments': 8, 'grouped_conv': 1,
                    'grouped_conv_bwd': 1}
# cls at 60 anchors with dropout > 0 in bf16: nothing deferred (the JAX
# package's ``fuse`` gate), so the plain intra conv (its forward and df on
# intra_conv_mma_kernel, its dW on intra_dw_mma_kernel) where the prenorm
# form ran, and in eval the unfused tail (the grouped conv at the 6 packed
# skips and the head, separate norms) where the fused one ran
DROPOUT = 0.5
DROPOUT_STEP = {**BF16_TRAIN_PER_STEP, 'intra_conv': 14, 'intra_conv_dw': 7,
                'intra_conv_prenorm': 0, 'intra_conv_prenorm_df': 0,
                'intra_conv_prenorm_dw': 0}
DROPOUT_EVAL = {**BF16_EVAL_PER_BATCH, 'intra_conv': 7,
                'intra_conv_prenorm': 0, 'grouped_conv': 7,
                'grouped_conv_tail': 0}


def anchor_inv_reg_opt(kind, kanchor, kpconv, root='unused'):
    opt = inv_opt(root) if kind == 'inv' else reg_opt(root)
    opt.model.kanchor, opt.model.kpconv = kanchor, kpconv
    return opt


def reg_anchor_loss(kanchor):
    """The rotation step's loss over the anchors of ``kanchor`` (the
    trainer's: the full group's with kpconv, whose one-anchor model
    regresses directly)."""
    def loss(model, batch):
        import torch
        from epn_pointcloud_tpu_torch import losses
        from epn_pointcloud_tpu_torch.ops import icosahedron
        pc, rlabel, T, R = batch
        wts, y = model(pc)
        anchors = torch.from_numpy(icosahedron.get_anchors(kanchor)).to(pc)
        return losses.multi_task_detection_loss(anchors, wts, rlabel, y, R,
                                                T, nr=4)[0]
    return loss


def _routes_below_60(tag, rows, dtype, na):
    """The compared rows' launches by kernel, printed; every inter call on
    its template (the bf16 forward on the tensor-core kernel from
    MMA_MIN_NA anchors): 'sgemm' / 'mma', 'dtable', 'dw', 'f', 'dg'."""
    routes = _route_table(rows)
    log(f'{tag} {dtype} launches by kernel {routes}')
    want = {'inter_conv': 'mma' if dtype == 'bf16' and na > 1 else 'sgemm',
            'inter_conv_dtable': 'dtable', 'inter_conv_dw': 'dw',
            'inter_conv_f': 'f', 'inter_conv_dg': 'dg'}
    for name, route in want.items():
        if rows.get(name):
            assert routes[name] == {route: len(rows[name])}, (name, routes)
    return routes


def phase_anchor_inv_reg(tag, device, inv_root, reg_root):
    """inv_so3net_pn (b=48 descriptor forward, the triplet step of two legs
    of 16 patches) or reg_so3net (b=8 pairs: the pair forward and its step)
    at kanchor 20 or one anchor, full width, seeded, in fp32 and bf16: each
    kernel call against its plain version through the shared checker
    (``check_calls``: every kernel's extras), the inter calls' routes
    printed and held to their templates (the W-off F and dG to 'f' / 'dg',
    whose envelope now takes any anchor count); the forward kernel vs plain
    path (fp32 rtol 1e-3, atol 2e-3; bf16 per-sample cosine to the plain
    path at the kernel's rounding points >= 0.999, or that reference's own
    cosine to fp32 where lower); the step's loss kernel vs plain path (fp32
    rtol 1e-5 with per-leaf gradients by ``_grads_close``, bf16 rtol 1e-3);
    the whole forward and step timed."""
    import torch
    from epn_pointcloud_tpu_torch import models
    from epn_pointcloud_tpu_torch.ops import kernels
    kind, kanchor, kpconv = ANCHOR_INV_REG[tag]
    na = 1 if kpconv else kanchor
    opt = anchor_inv_reg_opt(kind, kanchor, kpconv)
    if kind == 'inv':
        src, tgt = inv_legs(inv_root, device, items=(0, 1))
        x = torch.cat([src, tgt])[:INV_DESC_BATCH].contiguous()
        batch = (src[:INV_BATCH].contiguous(), tgt[:INV_BATCH].contiguous())
        loss, n_fwd, n_step = inv_loss, INV_DESC_BATCH, 2 * INV_BATCH
    else:
        ropt = reg_opt(reg_root)
        ropt.model.kanchor = kanchor
        batch = reg_batch(reg_root, device, opt=ropt)
        x, loss = batch[0], reg_anchor_loss(kanchor)
        n_fwd = n_step = 2 * REG_BATCH
    model = models.build_model_from(opt, seed=SEED).to(device).eval()
    assert model.params['na'] == na
    out = {'na': na, 'results': {}}
    for dtype in ('fp32', 'bf16'):
        calls, y = forward_calls(model, x, dtype)
        assert torch.isfinite(y).all()
        expect = {n: k for n, k in A_EVAL[kind].items() if k}
        if dtype == 'bf16' and na > 1:
            expect['moments'] = expect['ball_query']
        assert _call_counts(calls) == expect, (_call_counts(calls), expect)
        with compute_dtype(dtype), torch.no_grad():
            rows = check_calls(f'{tag} {dtype}', calls, ALL_FWD, dtype,
                               routes=BELOW_60_ROUTES)
        out[f'{dtype}_routes'] = _routes_below_60(tag, rows, dtype, na)
        out['results'][dtype] = rows
        del calls
    with torch.no_grad():
        yk = model(x)[0]
        with kernels.plain():
            yp = model(x)[0]
        torch.testing.assert_close(yk, yp, rtol=1e-3, atol=2e-3)
        with compute_dtype('bf16'):
            b16 = model(x)[0]
            with plain_at_rounding_points():
                r16 = model(x)[0]
        flat = lambda t: t.reshape(t.shape[0], -1).float()
        cos_r = float(_cosine(flat(b16), flat(r16)).min())
        ref32 = float(_cosine(flat(r16), flat(yp)).min())
        cos32 = float(_cosine(flat(b16), flat(yk)).min())
    assert torch.isfinite(b16).all()
    assert cos_r >= min(0.999, ref32), (cos_r, ref32)
    out.update(fp32_max_abs_err=float((yk - yp).abs().max()),
               bf16_vs_rounding_min_cos=cos_r,
               rounding_vs_fp32_min_cos=ref32, bf16_vs_fp32_min_cos=cos32)
    del yk, yp, b16, r16
    for dtype in ('fp32', 'bf16'):
        k_ms, p_ms = forward_wall(model, x, dtype)
        out[f'{dtype}_forward_ms'], out[f'{dtype}_plain_forward_ms'] = \
            k_ms, p_ms
    log(f'{tag} {n_fwd}-cloud forward (na={na}): fp32 kernel vs plain path '
        f'max_abs_err {out["fp32_max_abs_err"]:.3e} (rtol 1e-3, atol '
        f'2e-3); bf16 kernel path vs the plain path at its rounding points '
        f'min per-sample cosine {cos_r:.7f} (>= the lower of 0.999 and '
        f'{ref32:.7f}, that reference vs fp32); bf16 vs fp32 kernel path '
        f'{cos32:.7f} (printed); whole forward fp32 '
        f'{out["fp32_forward_ms"]:.2f} ms (plain '
        f'{out["fp32_plain_forward_ms"]:.2f}), bf16 '
        f'{out["bf16_forward_ms"]:.2f} ms (plain '
        f'{out["bf16_plain_forward_ms"]:.2f})')
    del model
    torch.cuda.empty_cache()

    for dtype in ('fp32', 'bf16'):
        mk, mp = (models.build_model_from(opt, seed=SEED).to(device).train()
                  for _ in range(2))
        kernels.reset_counts()
        losses_k = []

        def step():
            lk = loss(mk, batch)
            lk.backward()
            losses_k.append(lk.item())
        with compute_dtype(dtype):
            calls = capture_calls(ALL_STEP, step)
            counts_k = kernels.counts()
            with kernels.plain():
                loss_p = loss(mp, batch)
                loss_p.backward()
        torch.cuda.synchronize()
        assert kernels.counts() == counts_k, 'the plain path launched a kernel'
        expect = dict(A_STEP[kind])
        if dtype == 'bf16' and na > 1:
            expect['moments'] = expect['ball_query']
        assert counts_k == expect, (counts_k, expect)
        lk, lp = losses_k[0], loss_p.item()
        rtol = 1e-5 if dtype == 'fp32' else 1e-3
        assert abs(lk - lp) <= rtol * abs(lp), (lk, lp)
        bad, worst = [], (0.0, '')
        if dtype == 'fp32':
            if kind == 'inv':
                f64 = _max_abs(inv_f64_grads(mp, batch))
            else:
                f64 = reg_f64_max(mp, batch, loss=loss)
            pk = dict(mk.named_parameters())
            for name, p in mp.named_parameters():
                zero = torch.zeros_like(p)
                g = pk[name].grad
                ok, msg = _grads_close(
                    name, zero if g is None else g,
                    zero if p.grad is None else p.grad, f64[name])
                if not ok:
                    bad.append(msg)
                if f64[name] > 1e-5 and g is not None:
                    worst = max(worst, (rel_err(g, p.grad), name))
            assert not bad, bad
        log(f'{tag} {dtype} step ({n_step} clouds): loss kernel path '
            f'{lk:.7f}, plain path {lp:.7f} (rtol {rtol})'
            + (f'; worst real leaf relative L2 {worst[0]:.3e} {worst[1]}'
               if dtype == 'fp32' else '')
            + f'; launches {counts_k}')
        with compute_dtype(dtype), torch.no_grad():
            rows = check_calls(f'{tag} {dtype} step', calls, ALL_STEP, dtype,
                               step=True, routes=BELOW_60_ROUTES)
        out[f'{dtype}_step_routes'] = _routes_below_60(f'{tag} step', rows,
                                                       dtype, na)
        out['results'][f'{dtype}_step'] = rows
        del calls
        mk.zero_grad(set_to_none=True)
        mp.zero_grad(set_to_none=True)
        _, k_ms, p_ms, _, _ = time_steps(mk, mp, batch, dtype, 3, loss=loss,
                                         tag=tag, n_clouds=n_step)
        out.update({f'{dtype}_loss_kernel': lk, f'{dtype}_loss_plain': lp,
                    f'{dtype}_step_ms': k_ms,
                    f'{dtype}_plain_step_ms': p_ms})
        if dtype == 'fp32':
            out['worst_grad_rel_l2'] = worst[0]
        del mk, mp
        torch.cuda.empty_cache()
    return out


def phase_ka20_bf16_train(device):
    """[ka20-bf16-train] The cls b=12 bf16 train step at kanchor 20 (seeded,
    norm biases perturbed): each kernel call against its plain version
    (``check_calls``, the templates' dTable and dW), and the step on the
    kernel path against the plain path from the same weights by the
    noise-floor rule (``bf16_step_check``); the step timed."""
    import torch
    from epn_pointcloud_tpu_torch import models
    opt = anchor_opt(20, False)
    batch = train_batch(device, SEED + 7)
    mk = perturb_norm_biases(models.build_model_from(opt, seed=SEED)).to(
        device).train()
    with compute_dtype('bf16'):
        calls = capture_calls(ALL_STEP,
                              lambda: step_loss(mk, batch).backward())
        with torch.no_grad():
            rows = check_calls('[ka20-bf16-train] calls', calls, ALL_STEP,
                               'bf16', step=True, routes=BELOW_60_ROUTES)
    del calls, mk
    routes = _routes_below_60('[ka20-bf16-train]', rows, 'bf16', 20)
    models_ = tuple(perturb_norm_biases(models.build_model_from(
        opt, seed=SEED)).to(device).train()
        for _ in range(3 + len(NOISE_SCALES)))
    mk, mp = models_[:2]
    out = bf16_step_check(
        f'[ka20-bf16-train] b={TRAIN_BATCH}', models_, step_loss, batch,
        [(batch[0] * sc,) + batch[1:] for sc in NOISE_SCALES],
        ANCHOR_BF16_STEP, f64_grad_max(mp, batch), 'clouds')
    del models_
    _, k_ms, p_ms, _, _ = time_steps(mk, mp, batch, 'bf16', 3,
                                     tag='[ka20-bf16-train]')
    del mk, mp
    torch.cuda.empty_cache()
    out.update(results={'step': rows}, routes=routes, step_ms=k_ms,
               plain_step_ms=p_ms)
    out.pop('leaves')
    return out


def _seed_dropout(model, seed):
    """The model's dropout masks from a generator on its device seeded
    with ``seed`` (two models seeded alike draw the same masks)."""
    import torch
    from epn_pointcloud_tpu_torch.nn.layers import set_dropout_generator
    dev = next(model.parameters()).device
    set_dropout_generator(model, torch.Generator(dev).manual_seed(seed))


def phase_dropout(device):
    """[dropout] cls_so3net_pn at 60 anchors with --dropout-rate 0.5, full
    width, seeded: a b=12 bf16 train step whose launches show the JAX
    package's gates (the plain intra conv and its tensor-core dW, no
    prenorm kernel) and whose every kernel call is held to its plain
    version, the step kernel vs plain path on the same masks (loss to rtol
    1e-3, every real leaf at a cosine >= BF16_LEAF_COS); a b=32 bf16 eval
    with no fused tail (B3) launched, every call held to its plain version,
    its logits against the dropout-free model's on the same weights (which
    runs the fused tail): per-sample cosine >= 0.999; both timed."""
    import copy
    import torch
    from epn_pointcloud_tpu_torch import models
    from epn_pointcloud_tpu_torch.ops import kernels
    opt = full_opt()
    opt.model.dropout_rate = DROPOUT
    names = ALL_STEP + ('intra_conv_df',)
    mk, mp = (perturb_norm_biases(models.build_model_from(
        opt, seed=SEED)).to(device).train() for _ in range(2))
    batch = train_batch(device, SEED + 8)
    out = {'results': {}}
    with compute_dtype('bf16'):
        kernels.reset_counts()
        _seed_dropout(mk, 5)
        losses_k = []

        def step():
            lk = step_loss(mk, batch)
            lk.backward()
            losses_k.append(lk.item())
        calls = capture_calls(names, step)
        counts, routes = kernels.counts(), route_counts()
        _seed_dropout(mp, 5)
        with kernels.plain():
            loss_p = step_loss(mp, batch)
            loss_p.backward()
        torch.cuda.synchronize()
        check_routes('[dropout] step', 'bf16', counts, routes)
        assert counts == DROPOUT_STEP, (counts, DROPOUT_STEP)
        assert routes['intra']['dw_mma'] == DROPOUT_STEP['intra_conv_dw']
        lk, lp = losses_k[0], loss_p.item()
        assert abs(lk - lp) <= 1e-3 * abs(lp), (lk, lp)
    # the float64 step on the same masks marks the degenerate leaves (the
    # BatchNorm over block 0's constant field)
    m64 = copy.deepcopy(mp).double()
    m64.zero_grad(set_to_none=True)
    _seed_dropout(m64, 5)
    with kernels.plain():
        step_loss(m64, (batch[0].double(),) + batch[1:]).backward()
    f64 = {n: float(p.grad.abs().max()) for n, p in m64.named_parameters()}
    del m64
    with compute_dtype('bf16'):
        pk = dict(mk.named_parameters())
        cos = {n: _leaf_cos(pk[n].grad, p.grad)
               for n, p in mp.named_parameters() if f64[n] > 1e-5}
        worst = min(cos, key=cos.get)
        assert cos[worst] >= BF16_LEAF_COS, (worst, cos[worst])
        log(f'[dropout] b={TRAIN_BATCH} bf16 step, rate {DROPOUT}: loss '
            f'kernel path {lk:.7f}, plain path {lp:.7f} (rtol 1e-3); '
            f'per-leaf gradient cosine over {len(cos)} real leaves (float64 '
            f'> 1e-5) min {cos[worst]:.5f} at {worst}, median '
            f'{statistics.median(cos.values()):.5f}; launches {counts}; by '
            f'kernel {routes}')
        with torch.no_grad():
            rows = check_calls('[dropout] step', calls, names, 'bf16',
                               step=True)
        del calls
        out['results']['step'] = rows
        out.update(step_launches=counts, step_routes=routes, loss_kernel=lk,
                   loss_plain=lp, min_grad_cos=cos[worst],
                   median_grad_cos=statistics.median(cos.values()))
        mk.zero_grad(set_to_none=True)
        mp.zero_grad(set_to_none=True)
    _, k_ms, p_ms, _, _ = time_steps(mk, mp, batch, 'bf16', 3,
                                     tag='[dropout]')
    out.update(step_ms=k_ms, plain_step_ms=p_ms)
    del mk, mp
    torch.cuda.empty_cache()

    model = models.build_model_from(opt, seed=SEED).to(device).eval()
    plain_opt = full_opt()
    ref = models.build_model_from(plain_opt, seed=SEED).to(device).eval()
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(device)
    kernels.reset_counts()
    calls, logits = forward_calls(model, x, 'bf16')
    counts = kernels.counts()
    assert counts == DROPOUT_EVAL, (counts, DROPOUT_EVAL)
    with compute_dtype('bf16'), torch.no_grad():
        rows = check_calls('[dropout] eval', calls, ALL_FWD, 'bf16')
        tail = ref(x)[0]
    del calls
    cos = float(_cosine(logits, tail).min())
    assert torch.isfinite(logits).all() and cos >= 0.999, cos
    k_ms, p_ms = forward_wall(model, x, 'bf16')
    r_ms, _ = forward_wall(ref, x, 'bf16')
    log(f'[dropout] b={BATCH} bf16 eval, rate {DROPOUT}: launches {counts} '
        f'(no fused tail); logits against the dropout-free model (fused '
        f'tail) min per-sample cosine {cos:.7f} (>= 0.999); whole forward '
        f'{k_ms:.2f} ms (plain path {p_ms:.2f}; the fused-tail model '
        f'{r_ms:.2f})')
    out['results']['eval'] = rows
    out.update(eval_launches=counts, eval_vs_fused_min_cos=cos,
               forward_ms=k_ms, plain_forward_ms=p_ms, fused_forward_ms=r_ms)
    del model, ref
    torch.cuda.empty_cache()
    return out


def phase_option_entries(inv_root, reg_root):
    """This slice's main paths, each kernel's launches counted from 0
    before each run and held to the per-step and per-batch counts:
    run_3dmatch --kanchor 20 train -i 2, then its checkpoint through
    --run-mode eval -r on the synthetic scene (features, recall.csv);
    run_modelnet_rotation --kanchor 20 train -i 2 (with its testR eval),
    then --run-mode eval -r; run_modelnet --dropout-rate 0.5 --debug-mode
    knownatt -u attention --compute-dtype bf16 train -i 2 (the attention
    model trained as a classifier: Summary Loss and Acc, no prenorm or
    fused-tail launch). Every W-off call on its template ('f', 'dg')."""
    import numpy as np
    import torch
    from epn_pointcloud_tpu_torch import run_3dmatch, run_modelnet
    from epn_pointcloud_tpu_torch import run_modelnet_rotation as rot
    from epn_pointcloud_tpu_torch.data import synthetic
    from epn_pointcloud_tpu_torch.ops import kernels, so3conv
    out = {}
    steps = 2
    work = os.path.join(ROOT, 'build', 'chip_smoke_options')
    shutil.rmtree(work, ignore_errors=True)

    def run(tag, main, argv, **kw):
        kernels.reset_counts()
        t0 = time.time()
        try:
            trainer = main(argv, **kw)
            torch.cuda.synchronize()
        finally:
            so3conv.set_compute_dtype('fp32')
        wall = time.time() - t0
        counts, routes = kernels.counts(), route_counts()
        trainer.logger.close()
        log(f'{tag} wall {wall:.2f} s; launches {counts}; inter by kernel '
            f'{ {k: v for k, v in routes["inter"].items() if v} }')
        return trainer, counts, routes, wall

    def held(counts, routes, want_counts):
        assert counts == want_counts, (counts, want_counts)
        inter = {k: v for k, v in routes['inter'].items() if v}
        want = {'sgemm': counts['inter_conv'],
                'dtable': counts['inter_conv_dtable'],
                'dw': counts['inter_conv_dw'], 'f': counts['inter_conv_f'],
                'dg': counts['inter_conv_dg']}
        assert inter == {k: v for k, v in want.items() if v}, (inter, want)

    # run_3dmatch --kanchor 20: train, then the descriptor eval
    common = ['experiment', '-d', inv_root, '--kanchor', '20',
              '--model-dir', os.path.join(work, 'runs')]
    tag = '[inv-ka20-entry]'
    trainer, counts, routes, wall = run(
        tag, run_3dmatch.main, common + ['--run-mode', 'train', '-i',
                                         str(steps), '--save-freq',
                                         str(steps), '-lf', '1'])
    assert trainer.model.params['na'] == 20
    stats = dict(trainer.summary.running_stats)
    assert all(math.isfinite(stats[k]) for k in ('Loss', 'Pos', 'Neg',
                                                 'Acc'))
    held(counts, routes, {n: steps * k for n, k in INV_A_STEP.items()})
    out['inv_train'] = {'launches': counts, 'wall_s': wall,
                        'running_stats': stats}
    root = eval_tree()
    cwd = os.path.join(work, 'cwd_eval')
    rel = os.path.join('trained_models', 'models', 'inv_ka20', 'ckpt',
                       os.path.basename(trainer.last_ckpt))
    os.makedirs(os.path.dirname(os.path.join(cwd, rel)))
    shutil.copy(trainer.last_ckpt, os.path.join(cwd, rel))
    with working_dir(cwd):
        other, counts, routes, wall = run(
            f'{tag} eval', run_3dmatch.main,
            ['experiment', '-d', root, '--run-mode', 'eval', '-r', rel,
             '--kanchor', '20', '--model-dir', 'runs'], scenes=[EVAL_SCENE])
        feat_dir = os.path.join('data', 'evaluate', '3DMatch', 'inv_ka20',
                                EVAL_SCENE, '32_dim')
        feats = [np.load(os.path.join(feat_dir, f'feature{i}.npy'))
                 for i in range(3)]
        with open(os.path.join('trained_models', 'evaluate', '3DMatch',
                               'inv_ka20', 'recall.csv')) as f:
            recall = f.read()
    n_chunks = 3 * -(-EVAL_KPTS // EVAL_CHUNK)
    held(counts, routes, {n: n_chunks * k for n, k in INV_A_EVAL.items()})
    assert all(f.shape == (EVAL_KPTS, 64) and np.isfinite(f).all()
               for f in feats) and EVAL_SCENE in recall
    for (k, a), (_, b) in zip(trainer.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), k
    log(f'{tag} eval -r: features {[f.shape for f in feats]}, recall.csv '
        f'{recall!r}, host seconds {dict(other.eval_seconds)}')
    out['inv_eval'] = {'launches': counts, 'wall_s': wall,
                       'seconds': dict(other.eval_seconds)}
    del trainer, other

    # run_modelnet_rotation --kanchor 20: train (and its eval), then eval
    tag = '[reg-ka20-entry]'
    common = ['experiment', '-d', reg_root, '--kanchor', '20',
              '--model-dir', os.path.join(work, 'runs')]
    with working_dir(os.path.join(work, 'cwd_rot')):
        trainer, counts, routes, wall = run(
            tag, rot.main, common + ['-i', str(steps), '--save-freq',
                                     str(steps), '-lf', '1'])
        n_eval = len(trainer.dataset_test)
        held(counts, routes, {n: steps * k + n_eval * REG_A_EVAL[n]
                              for n, k in REG_A_STEP.items()})
        stats = dict(trainer.summary.running_stats)
        assert all(math.isfinite(stats[k]) for k in ('Loss', 'Reg_Loss',
                                                     'Mean_Err', 'R_Acc'))
        out['reg_train'] = {'launches': counts, 'wall_s': wall,
                            'running_stats': stats}
        other, counts, routes, wall = run(
            f'{tag} eval', rot.main, common + ['--run-mode', 'eval', '-r',
                                               trainer.last_ckpt])
        errors = np.loadtxt(os.path.join(
            'data', 'alignment_errors', f'{other.exp_name}_error.txt'))
    n_other = len(other.dataset_test)
    held(counts, routes, {n: n_other * k for n, k in REG_A_EVAL.items()})
    median = float(np.median(errors) * 180 / np.pi)
    assert errors.size == n_other * REG_BATCH and math.isfinite(median)
    log(f'{tag} eval -r: {errors.size} pairs, median angular error '
        f'{median:.3f} degrees')
    out['reg_eval'] = {'launches': counts, 'wall_s': wall,
                       'median_deg': median}
    del trainer, other

    # run_modelnet --dropout-rate 0.5 --debug-mode knownatt -u attention
    tag = '[dropout-entry]'
    tree = os.path.join(work, 'modelnet')
    synthetic.make_modelnet_tree(tree, n_cats=4, n_train=6, n_test=6,
                                 n_points=N_POINTS, seed=0,
                                 splits=('train', 'testR'))
    trainer, counts, routes, wall = run(
        tag, run_modelnet.main,
        ['experiment', '-d', tree, '--run-mode', 'train', '-i', str(steps),
         '--save-freq', str(steps), '-lf', '1', '--dropout-rate',
         str(DROPOUT), '--debug-mode', 'knownatt', '-u', 'attention',
         '--compute-dtype', 'bf16', '--model-dir',
         os.path.join(work, 'runs')])
    n_eval = len(trainer.eval_logits)
    check_routes(tag, 'bf16', counts, routes)
    expect = {n: steps * k + n_eval * DROPOUT_EVAL[n]
              for n, k in DROPOUT_STEP.items()}
    assert counts == expect, (counts, expect)
    assert trainer.knownatt and not trainer.attention_model
    assert set(trainer.summary.items) == {'Time', 'Loss', 'Acc'}
    stats = dict(trainer.summary.running_stats)
    assert all(math.isfinite(stats[k]) for k in ('Loss', 'Acc'))
    log(f'{tag} running stats {stats}; test accuracy '
        f'{trainer.test_accs[-1]:.2f}% over {n_eval} batches')
    out['dropout_train'] = {'launches': counts, 'wall_s': wall,
                            'running_stats': stats}
    del trainer
    shutil.rmtree(work, ignore_errors=True)
    return out


# -------------------- xyz pooling, the ReLU, the remaining heads and modules

POOLINGS = ('stride', 'no-stride')
POOL_FWD = ALL_FWD + ('inter_conv_f',)
POOL_STEP = ALL_STEP + ('intra_conv_df',)
# launches of a pooled cls forward (7 layers, the first on the ones input,
# which is never pooled): every layer on the unfused path, the W-off F at
# the 6 with a feature table, one ball query a layer and one more for the
# blur of each strided layer with channels (blocks 1-3)
POOL_EVAL = {**_NO_BF16, **_NO_WOFF, 'fps': 1, 'ball_query': 10,
             'ones_conv': 1, 'inter_conv': 0, 'inter_conv_dtable': 0,
             'inter_conv_dw': 0, 'intra_conv': 7, 'intra_conv_dw': 0,
             'inter_conv_f': 6}
POOL_BF16_EVAL = {**POOL_EVAL, 'intra_conv': 0, 'intra_conv_prenorm': 7,
                  'moments': 7, 'grouped_conv': 1, 'grouped_conv_tail': 6}
# the fp32 b=12 step: the W-off F's backward is the W-off dG (6 layers)
POOL_STEP_COUNTS = {**POOL_EVAL, 'intra_conv': 14, 'intra_conv_dw': 7,
                    'inter_conv_dg': 6}


def pooled_model(mode, device, train=False):
    import torch  # noqa: F401
    from epn_pointcloud_tpu_torch.models import cls_so3net_pn
    model = cls_so3net_pn.build_model(full_opt(), xyz_pooling=mode,
                                      seed=SEED).to(device)
    return model.train() if train else model.eval()


def _logits_vs_plain(tag, model, x, dtype):
    """The b=32 logits of the kernel path against the plain path's: fp32 to
    rtol 1e-3, atol 2e-3 (``model_forward_checks``'s b=8 bound); bf16
    against the plain path at the kernels' rounding points
    (``plain_at_rounding_points``) by the per-sample cosine, >= 0.999 or
    that reference's own cosine to the fp32 plain path where it is lower
    (``model_forward_checks``'s b=32 rule); (max abs error or min
    cosine)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    with torch.no_grad(), compute_dtype(dtype):
        k = model(x)[0]
        if dtype == 'fp32':
            with kernels.plain():
                p = model(x)[0]
        else:
            with plain_at_rounding_points():
                p = model(x)[0]
    assert torch.isfinite(k).all(), tag
    if dtype == 'fp32':
        torch.testing.assert_close(k, p, rtol=1e-3, atol=2e-3)
        return float((k - p).abs().max())
    with torch.no_grad(), kernels.plain():
        ref = float(_cosine(p, model(x)[0]).min())
    cos = float(_cosine(k, p).min())
    assert cos >= min(0.999, ref), (tag, cos, ref)
    return cos


def _fp32_step_vs_plain(tag, mk, mp, batch, expect, names, calls=True):
    """One fp32 step on the kernel path (``mk``) and the plain path (``mp``)
    from the same weights: the launches ``expect`` (none on the plain
    path), the loss to rtol 1e-5 and every leaf by ``_grads_close``; with
    ``calls`` each kernel call held to its plain version (``check_calls``);
    timed. A dict of the numbers and the rows ({} without ``calls``)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    f64 = f64_grad_max(mp, batch)
    kernels.reset_counts()
    losses_k = []

    def step():
        loss = step_loss(mk, batch)
        loss.backward()
        losses_k.append(loss.item())
    check, calls = calls, capture_calls(names, step)
    counts_k, routes = kernels.counts(), route_counts()
    with kernels.plain():
        loss_p = step_loss(mp, batch)
        loss_p.backward()
    torch.cuda.synchronize()
    assert kernels.counts() == counts_k, 'the plain path launched a kernel'
    assert counts_k == expect, (counts_k, expect)
    lk, lp = losses_k[0], loss_p.item()
    assert abs(lk - lp) <= 1e-5 * abs(lp), (lk, lp)
    bad, worst = [], (0.0, '')
    pk = dict(mk.named_parameters())
    for name, p in mp.named_parameters():
        zero = torch.zeros_like(p)
        g = pk[name].grad
        ok, msg = _grads_close(name, zero if g is None else g,
                               zero if p.grad is None else p.grad, f64[name])
        if not ok:
            bad.append(msg)
        if f64[name] > 1e-5 and g is not None:
            worst = max(worst, (float((g - p.grad).norm()
                                      / p.grad.norm().clamp(min=1e-30)),
                                name))
    assert not bad, bad
    log(f'{tag} b={TRAIN_BATCH} fp32 train step: loss kernel path {lk:.7f}, '
        f'plain path {lp:.7f} (rtol 1e-5); {len(pk)} leaves, worst relative '
        f'L2 {worst[0]:.3e} at {worst[1]}; launches {counts_k}; by kernel '
        f'{routes}')
    rows = {}
    if check:
        with torch.no_grad():
            rows = check_calls(f'{tag} step', calls, names, 'fp32',
                               step=True)
    del calls
    mk.zero_grad(set_to_none=True)
    mp.zero_grad(set_to_none=True)
    _, k_ms, p_ms, _, _ = time_steps(mk, mp, batch, 'fp32', 3, tag=tag)
    return {'rows': rows, 'launches': counts_k, 'routes': routes,
            'loss_kernel': lk, 'loss_plain': lp, 'worst_grad_rel_l2': worst[0],
            'step_ms': k_ms, 'plain_step_ms': p_ms}


def phase_pooling(device):
    """[pooling] cls_so3net_pn at 60 anchors, 1024 points, full width,
    built with xyz_pooling 'stride' and with 'no-stride' (every inter conv
    on the unfused path: the blur, the grouping, the W-off F, the learned
    product by torch.mm): each kernel call of a b=32 forward against its
    plain version (``check_calls``; both modes in both dtypes), the W-off F
    on its CUDA-core ('f_f32') and tensor-core ('f_mma') kernels at every
    layer, the launches of each forward, the
    logits against the plain path, all four forwards timed; then a b=12
    fp32 step of the 'stride' model, kernel vs plain path by the per-leaf
    rule (``_grads_close``), its calls held to their plain versions,
    timed."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(device)
    out = {'results': {}}
    for mode in POOLINGS:
        model = pooled_model(mode, device)
        assert all(layer['args']['pooling'] == mode
                   for block in model.params['backbone'] for layer in block)
        for dtype, expect, route in (('fp32', POOL_EVAL, 'f_f32'),
                                     ('bf16', POOL_BF16_EVAL, 'f_mma')):
            kernels.reset_counts()
            calls, logits = forward_calls(model, x, dtype, POOL_FWD)
            counts, rt = kernels.counts(), route_counts()
            assert counts == expect, (mode, dtype, counts, expect)
            assert rt['inter'][route] == 6, rt
            assert logits.shape == (BATCH, 40)
            with compute_dtype(dtype), torch.no_grad():
                rows = check_calls(f'[pooling] {mode} {dtype}', calls,
                                   POOL_FWD, dtype)
            assert _route_table(rows)['inter_conv_f'] == {route: 6}
            routes = {'inter': {k: v for k, v in rt['inter'].items() if v},
                      'intra': {k: v for k, v in rt['intra'].items() if v}}
            del calls
            agree = _logits_vs_plain(f'[pooling] {mode}', model, x, dtype)
            k_ms, p_ms = forward_wall(model, x, dtype)
            log(f'[pooling] {mode} b={BATCH} {dtype} forward: launches '
                f'{counts}; by kernel {routes}; logits vs the plain path '
                f'{"max_abs_err" if dtype == "fp32" else "min cosine"} '
                f'{agree:.3e}; whole forward {k_ms:.2f} ms '
                f'({1e3 * BATCH / k_ms:.1f} clouds/s; plain path '
                f'{p_ms:.2f})')
            key = f'{mode}_{dtype}'
            out['results'][key] = rows
            out[key] = {'launches': counts, 'routes': routes,
                        'logits_vs_plain': agree, 'forward_ms': k_ms,
                        'plain_forward_ms': p_ms}
            torch.cuda.empty_cache()
        del model
    mk, mp = (perturb_norm_biases(pooled_model('stride', device, True))
              for _ in range(2))
    step = _fp32_step_vs_plain('[pooling] stride', mk, mp,
                               train_batch(device, SEED + 9),
                               POOL_STEP_COUNTS, POOL_STEP)
    out['results']['step'] = step.pop('rows')
    out['step'] = step
    del mk, mp
    torch.cuda.empty_cache()
    return out


def relu_model(device, train=False):
    """cls_so3net_pn at full width with every block's activation 'relu'
    (the tree of ``build_model``, the activation set in each layer)."""
    import json as _json
    from epn_pointcloud_tpu_torch.models import cls_so3net_pn
    params = _json.loads(_json.dumps(
        cls_so3net_pn.build_model(full_opt(), seed=None).params))
    for block in params['backbone']:
        for layer in block:
            layer['args']['activation'] = 'relu'
    model = cls_so3net_pn.ClsSO3ConvModel(params, seed=SEED).to(device)
    return model.train() if train else model.eval()


def _slopes(rows):
    """{kernel: sorted slopes of its calls} of compared rows."""
    return {n: sorted({r['slope'] for r in rs})
            for n, rs in rows.items() if n in SLOPED}


def phase_relu(device):
    """[relu] The cls model with every activation 'relu': a b=32 bf16 eval
    (the prenorm intra conv and the fused tail at slope 0, every call held
    to its plain version at that slope), a b=12 fp32 step by the per-leaf
    rule (its kernels the leaky model's) and a b=12 bf16 step (B5, B6 df
    and dW at slope 0, each call held
    to its plain version; the step by the noise-floor rule,
    ``bf16_step_check``), all timed; then the leaky model's b=32 logits in
    both dtypes against the plain path (the kernels' leaky calls as
    before)."""
    import torch
    from epn_pointcloud_tpu_torch import models
    from epn_pointcloud_tpu_torch.ops import kernels
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(device)
    out = {'results': {}}
    model = relu_model(device)
    kernels.reset_counts()
    calls, logits = forward_calls(model, x, 'bf16')
    counts = kernels.counts()
    assert counts == BF16_EVAL_PER_BATCH, (counts, BF16_EVAL_PER_BATCH)
    with compute_dtype('bf16'), torch.no_grad():
        rows = check_calls('[relu] bf16 eval', calls, ALL_FWD, 'bf16')
    del calls
    slopes = _slopes(rows)
    assert slopes == {'intra_conv_prenorm': [0.0],
                      'grouped_conv_tail': [0.0]}, slopes
    agree = {d: _logits_vs_plain('[relu]', model, x, d)
             for d in ('fp32', 'bf16')}
    times = {d: forward_wall(model, x, d) for d in ('fp32', 'bf16')}
    log(f'[relu] b={BATCH} bf16 eval: launches {counts}; the ReLU calls\' '
        f'slopes {slopes}; logits vs the plain path fp32 max_abs_err '
        f'{agree["fp32"]:.3e}, bf16 min cosine {agree["bf16"]:.7f}; whole '
        f'forward fp32 {times["fp32"][0]:.2f} ms (plain {times["fp32"][1]:.2f}'
        f'), bf16 {times["bf16"][0]:.2f} ms (plain {times["bf16"][1]:.2f})')
    out['results']['bf16_eval'] = rows
    out.update(eval_launches=counts, logits_vs_plain=agree,
               forward_ms={d: t[0] for d, t in times.items()},
               plain_forward_ms={d: t[1] for d, t in times.items()})
    del model
    torch.cuda.empty_cache()

    mk, mp = (perturb_norm_biases(relu_model(device, True)) for _ in range(2))
    # in fp32 nothing is deferred: the step runs the leaky model's kernels
    # (their calls held in [backward]), the ReLU in torch after them
    step = _fp32_step_vs_plain('[relu] fp32', mk, mp,
                               train_batch(device, SEED + 10),
                               TRAIN_PER_STEP, ALL_STEP + ('intra_conv_df',),
                               calls=False)
    step.pop('rows')
    out['fp32_step'] = step
    del mk, mp

    batch = train_batch(device, SEED + 11)
    mk = perturb_norm_biases(relu_model(device, True))
    with compute_dtype('bf16'):
        calls = capture_calls(ALL_STEP,
                              lambda: step_loss(mk, batch).backward())
        with torch.no_grad():
            rows = check_calls('[relu] bf16 step', calls, ALL_STEP, 'bf16',
                               step=True)
    del calls, mk
    slopes = _slopes(rows)
    assert slopes == {'intra_conv_prenorm': [0.0],
                      'intra_conv_prenorm_df': [0.0],
                      'intra_conv_prenorm_dw': [0.0]}, slopes
    models_ = tuple(perturb_norm_biases(relu_model(device, True))
                    for _ in range(3 + len(NOISE_SCALES)))
    mk, mp = models_[:2]
    bf16_step = bf16_step_check(
        f'[relu] b={TRAIN_BATCH}', models_, step_loss, batch,
        [(batch[0] * sc,) + batch[1:] for sc in NOISE_SCALES],
        BF16_TRAIN_PER_STEP, f64_grad_max(mp, batch), 'clouds')
    bf16_step.pop('leaves')
    del models_
    _, k_ms, p_ms, _, _ = time_steps(mk, mp, batch, 'bf16', 3, tag='[relu]')
    bf16_step.update(step_ms=k_ms, plain_step_ms=p_ms, slopes=slopes)
    out['results']['bf16_step'] = rows
    out['bf16_step'] = bf16_step
    del mk, mp
    torch.cuda.empty_cache()

    leaky = models.build_model_from(full_opt(), seed=SEED).to(device).eval()
    kernels.reset_counts()
    out['leaky_logits_vs_plain'] = {
        d: _logits_vs_plain('[relu] leaky', leaky, x, d)
        for d in ('fp32', 'bf16')}
    log(f'[relu] the leaky model after: b={BATCH} logits vs the plain path '
        f'fp32 max_abs_err {out["leaky_logits_vs_plain"]["fp32"]:.3e}, bf16 '
        f'min cosine {out["leaky_logits_vs_plain"]["bf16"]:.7f}')
    del leaky
    torch.cuda.empty_cache()
    return out


# the heads no builder uses, on the cls backbone's last field (256 channels
# at 60 anchors): ClsOutBlockR with an intra conv block on its one-point
# field, InvOutBlockR, InvOutBlockPointnet
HEADS = {
    'ClsOutBlockR': {'dim_in': 256, 'mlp': [256], 'fc': [64], 'k': 40,
                     'pooling': 'attention', 'temperature': 3,
                     'kanchor': 60,
                     'intra': [{'args': {'dim_in': 256, 'dim_out': 256}}]},
    'InvOutBlockR': {'dim_in': 256, 'mlp': [128, 64], 'pooling': 'attention',
                     'temperature': 3, 'kanchor': 60},
    'InvOutBlockPointnet': {'dim_in': 256, 'mlp': [128, 64],
                            'pooling': 'max', 'kanchor': 60}}
PROP_FRAG = 16384         # points of the PropagationBlock's fragment
PROP_PARAMS = {'dim_in': 1, 'dim_out': 64, 'n_center': 256,
               'kernel_size': 1, 'radius': 0.4, 'sigma': 0.08,
               'kanchor': 60}


def _vs_plain(tag, fn, rtol=1e-4, atol=1e-4):
    """``fn()`` on the kernel path and inside ``kernels.plain()``: each
    output held to rtol / atol, its launches; (outputs, launches, kernel
    ms, plain ms)."""
    import torch
    from epn_pointcloud_tpu_torch.ops import kernels
    kernels.reset_counts()
    with torch.no_grad():
        got = fn()
        counts = {k: v for k, v in kernels.counts().items() if v}
        with kernels.plain():
            want = fn()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all(), tag
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
    with torch.no_grad():
        k_ms = time_ms(fn, reps=3, warmup=1)

        def plain():
            with kernels.plain():
                fn()
        p_ms = time_ms(plain, reps=3, warmup=1)
    return got, counts, k_ms, p_ms


def phase_heads_propagation(device):
    """[heads-propagation] Each head no builder uses (``HEADS``) on the
    full-width cls backbone's output (b=32, fp32), kernel vs plain path
    (ClsOutBlockR's intra conv on the one-point field: its calls held to
    their plain version); a PropagationBlock over a 16384-point fragment
    (the centers by the fps kernel, 256 of 1024 points a cloud, b=4), and a
    separable block at one anchor (stride 2, b=32 clouds of 1024 points,
    64 channels), each kernel vs plain path; all timed."""
    import numpy as np
    import torch
    from epn_pointcloud_tpu_torch import models
    from epn_pointcloud_tpu_torch.nn import blocks, heads
    from epn_pointcloud_tpu_torch.nn.layers import init_parameters
    from epn_pointcloud_tpu_torch.ops import so3conv
    from epn_pointcloud_tpu_torch.ops.so3conv import SphericalPointCloud
    out = {'results': {}}
    model = models.build_model_from(full_opt(), seed=SEED).to(device).eval()
    x = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED)).to(device)
    with torch.no_grad():
        field = so3conv.preprocess_input(x, 60)
        for bi, block in enumerate(model.backbone):
            field = block(field, ones_input=bi == 0)
    del model
    for i, (name, params) in enumerate(HEADS.items()):
        head = getattr(heads, name)(params)
        init_parameters(head, torch.Generator().manual_seed(SEED + i))
        head = head.to(device).eval()
        arg = field if name == 'InvOutBlockPointnet' else field.feats
        got, counts, k_ms, p_ms = _vs_plain(f'[heads] {name}',
                                            lambda: head(arg))
        want_counts = {'intra_conv': 1} if name == 'ClsOutBlockR' else {}
        assert counts == want_counts, (name, counts)
        rec = {'shapes': [tuple(g.shape) for g in got], 'launches': counts,
               'ms': k_ms, 'plain_ms': p_ms}
        if name == 'ClsOutBlockR':
            calls = capture_calls(('intra_conv',), lambda: head(arg))
            with torch.no_grad():
                rows = check_calls('[heads] ClsOutBlockR', calls,
                                   ('intra_conv',), 'fp32')
            out['results']['cls_out_block_r'] = rows
            rec['routes'] = _route_table(rows)
        log(f'[heads] {name} on the b={BATCH} backbone field '
            f'{tuple(field.feats.shape)}: outputs {rec["shapes"]} within '
            f'rtol 1e-4 of the plain path; launches {counts}; {k_ms:.3f} ms '
            f'(plain path {p_ms:.3f})')
        out[name] = rec
        del head
    del field, x
    torch.cuda.empty_cache()

    rng = np.random.RandomState(SEED)
    frag = torch.from_numpy(rng.uniform(-1, 1, (PROP_FRAG, 3)).astype(
        np.float32)).to(device)
    clouds = torch.from_numpy(synthetic_batch(4, N_POINTS, SEED + 2)).to(
        device)
    prop = blocks.PropagationBlock(PROP_PARAMS)
    init_parameters(prop, torch.Generator().manual_seed(SEED))
    prop = prop.to(device).eval()
    got, counts, k_ms, p_ms = _vs_plain(
        '[propagation]', lambda: prop(frag, clouds).feats)
    assert counts == {'fps': 1}, counts
    log(f'[propagation] PropagationBlock over a {PROP_FRAG}-point fragment, '
        f'{PROP_PARAMS["n_center"]} centers of 4 clouds: feats '
        f'{tuple(got[0].shape)} within rtol 1e-4 of the plain path; launches '
        f'{counts}; {k_ms:.3f} ms (plain path {p_ms:.3f})')
    out['propagation'] = {'launches': counts, 'ms': k_ms, 'plain_ms': p_ms}
    del prop, frag, clouds

    args = dict(dim_in=64, dim_out=64, kernel_size=1, stride=2, radius=0.4,
                sigma=0.08, n_neighbor=32, kanchor=1, norm='BatchNorm2d',
                activation='leaky_relu', dropout_rate=0.0, lazy_sample=True)
    blk = blocks.SeparableSO3ConvBlock(args)
    init_parameters(blk, torch.Generator().manual_seed(SEED))
    blk = blk.to(device).eval()
    xyz = torch.from_numpy(synthetic_batch(BATCH, N_POINTS, SEED + 3)).to(
        device)
    feats = torch.from_numpy(np.random.RandomState(SEED).randn(
        BATCH, N_POINTS, 1, 64).astype(np.float32)).to(device)
    spc = SphericalPointCloud(xyz, feats, None)
    got, counts, k_ms, p_ms = _vs_plain('[kanchor1]', lambda: blk(spc).feats)
    assert counts == {'ball_query': 1, 'inter_conv': 1}, counts
    log(f'[kanchor1] separable block at one anchor (no intra conv): feats '
        f'{tuple(got[0].shape)} within rtol 1e-4 of the plain path; '
        f'launches {counts}; {k_ms:.3f} ms (plain path {p_ms:.3f})')
    out['kanchor1'] = {'launches': counts, 'ms': k_ms, 'plain_ms': p_ms}
    del blk, spc
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ data parallelism

DP_DIR = os.path.join(ROOT, 'build', 'chip_smoke_dp')
# the [dp-nccl-1] steps (bitwise against no group) and the [dp-gloo-2] /
# [dp-nccl-2] steps (two ranks against one process), full width
DP1_TAGS = ('cls_fp32', 'cls_bf16', 'inv_fp32')
DP2_TAGS = ('cls_fp32', 'cls_bf16', 'inv_fp32', 'reg_fp32')
# the fp32 steps whose halves taken apart the gates must fail (reg's
# samples share no statistics: InstanceNorm)
DP2_CONTROL_TAGS = ('cls_fp32', 'inv_fp32')
DP2_TIMEOUT = 300        # seconds for the two ranks, start to exit
DP_SIZE = 'full'         # parallel.dryrun's size ('small' rehearses on a CPU)


_DP_F64 = {}


def _dp_f64(kind, device):
    """Each leaf's max |gradient| in one process's float64 step of ``kind``
    on the plain path (``dryrun.f64_grads``: it marks the leaves whose
    gradient is ~0), once a run."""
    from epn_pointcloud_tpu_torch.parallel import dryrun
    if kind not in _DP_F64:
        _DP_F64[kind] = dryrun.f64_grads(kind, DP_SIZE, device,
                                         os.path.join(DP_DIR, 'f64'))
    return _DP_F64[kind]


def _dp_launches(results):
    """Each kernel's launches in each step ({kernel: {tag: n}}; the counts
    set to 0 before each step)."""
    by_kernel = {}
    for tag, res in results.items():
        for k, n in json.loads(str(res['launches']))['counts'].items():
            by_kernel.setdefault(k, {})[tag] = n
    return by_kernel


def phase_dp_nccl_1(device, reps=5, backend='nccl'):
    """[dp-nccl-1] A NCCL world of one rank in this process
    (``init_method`` tcp://127.0.0.1), each step of DP1_TAGS through the
    trainer's distributed path (the weights broadcast, the gradients
    all-reduced; one rank keeps the local norms) against the same step of
    a trainer with no group (``dryrun.check_group_of_one``): bitwise the
    weights, loss, running statistics, the all-reduce's gradients and the
    parameters after Adam; the gradients to the step alone's as close as
    a repeat of it (``dryrun.REPEAT_ERR`` of each real leaf's max by
    dtype, the degenerate leaves within ``DEGENERATE_ERR`` of the largest:
    the fused dTable's atomics change their last bits from run to run).
    Each step's median time (CUDA events, the two
    trainers in turns) with and without the group; the group destroyed at
    the end."""
    import torch
    from epn_pointcloud_tpu_torch.parallel import distributed, dryrun
    out = os.path.join(DP_DIR, 'nccl1')
    # one host: NCCL's bootstrap on the loopback (the machine may have no
    # other interface)
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    alone = {}
    for tag in DP1_TAGS:
        _dp_f64(dryrun.STEPS[tag][0], device)
        tr = dryrun.build_trainer(tag, DP_SIZE, device, out)
        init = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        alone[tag] = (tr, init, dryrun.one_step(tr, tag, DP_SIZE))
    distributed.init_distributed(
        backend=backend, world_size=1, rank=0,
        init_method=f'tcp://127.0.0.1:{dryrun.free_port()}')
    rows, launched = {}, {}
    try:
        for tag in DP1_TAGS:
            kind, dtype, _ = dryrun.STEPS[tag]
            tr0, init, want = alone.pop(tag)
            tr1 = dryrun.build_trainer(tag, DP_SIZE, device, out)
            assert tr1.group is not None and tr0.group is None
            got, gaps = dryrun.check_group_of_one(tr1, tag, DP_SIZE, init,
                                                  want, _dp_f64(kind, device))
            launched[tag] = got
            coll = json.loads(str(got['launches']))['collectives']
            assert coll.get('grads') == 1, coll
            data = dryrun.local_data(kind, dryrun.global_batch(kind,
                                                               DP_SIZE))
            with compute_dtype(dtype):
                ms0, ms1 = time_abba(
                    lambda: tr0._optimize(data), lambda: tr1._optimize(data),
                    timer=lambda fn: time_ms(fn, reps=reps, warmup=1))
            grads = dryrun.leaves(want, ('grad/',))
            rows[tag] = {'ms_no_group': ms0, 'ms_nccl_group': ms1,
                         'overhead_ms': ms1 - ms0, 'leaves': len(grads),
                         'grad_bytes': int(sum(v.size * 4
                                               for v in grads.values())),
                         'grads_from_step_alone': gaps, 'collectives': coll}
            log(f'[dp-nccl-1] {tag}: weights, loss, running statistics, '
                f'the all-reduced gradients and the parameters after Adam '
                f'bitwise as with no group; the gradients from the step '
                f'alone as a repeat of it ({gaps["max_err"]:.2e} of a real '
                f'leaf max, {gaps["degenerate_leaves"]} degenerate within '
                f'{gaps["degenerate_err"]:.2e} of the largest); step '
                f'{ms0:.2f} ms alone, {ms1:.2f} ms with the NCCL group of '
                f'one ({ms1 - ms0:+.2f} ms; median of {reps} a turn, two '
                f'turns each); collectives {coll}')
            del tr0, tr1
            torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    return {'steps': rows, 'launches': _dp_launches(launched)}


def phase_dp_two(device, backend):
    """[dp-gloo-2] / [dp-nccl-2] Two ranks (``parallel.dryrun.launch``:
    two processes with the rendezvous environment; gloo: both on cuda:0,
    NCCL: one card a rank), each step of DP2_TAGS at full width on a rank's
    half of the global batch, against this process's step on the whole
    batch (``dryrun.compare``: the fp32 gates fixed from the card's
    readings, ``dp_variants``); the cls and inv fp32 steps on each half
    taken apart (statistics and negatives over a rank's half) must fail
    those gates; both ranks' gradients, parameters and statistics bitwise
    equal; every kernel and route of the one-process step launched on each
    rank. Correctness only: two ranks sharing one card say nothing of
    speed."""
    import threading
    import numpy as np
    import torch
    from epn_pointcloud_tpu_torch.parallel import dryrun
    tag0 = f'[dp-{backend}-2]'
    out = os.path.join(DP_DIR, backend)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    torch.cuda.empty_cache()
    argv = ['--out', out, '--size', DP_SIZE, '--backend', backend,
            '--steps', ','.join(DP2_TAGS)] + (
        ['--device', 'cpu' if device.type == 'cpu' else 'cuda:0']
        if backend == 'gloo' else [])
    failed = []

    def ranks():
        try:
            dryrun.launch(2, argv, DP2_TIMEOUT, os.path.join(out, 'logs'))
        except Exception as e:     # re-raised below, after the join
            failed.append(e)
    t0 = time.time()
    th = threading.Thread(target=ranks)
    th.start()
    local = os.path.join(out, 'one')
    want = {tag: dryrun.run_step(tag, DP_SIZE, device, local)
            for tag in DP2_TAGS}
    noise = dryrun.run_step(
        'cls_bf16', DP_SIZE, device, local,
        batch=dryrun.scale_clouds(dryrun.global_batch('cls', DP_SIZE)))
    # the fault the fp32 gates must catch: each half's statistics and
    # negatives taken apart (one process on each half, the means)
    control = {}
    for tag in DP2_CONTROL_TAGS:
        kind = dryrun.STEPS[tag][0]
        control[tag] = dryrun.leaf_gaps(dryrun.mean_of([
            dryrun.run_step(tag, DP_SIZE, device, local, batch=h)
            for h in dryrun.halves(kind, dryrun.global_batch(kind, DP_SIZE))
        ]), want[tag], _dp_f64(kind, device))
        del control[tag]['cos'], control[tag]['err']
        assert not dryrun.fp32_gates_hold(kind, control[tag]), \
            f'{tag0} {tag}: the gates pass each half taken apart {control[tag]}'
    th.join()
    if failed:
        raise failed[0]
    ranks_wall = time.time() - t0
    rows, launched, bad = {}, {}, []
    for tag in DP2_TAGS:
        got = [dict(np.load(os.path.join(out, f'{tag}_rank{r}.npz')))
               for r in (0, 1)]
        for k in dryrun.leaves(got[0], ('grad/', 'param/', 'buffer/')):
            assert np.array_equal(got[0][k], got[1][k]), \
                f'{tag0} {tag}: the ranks differ at {k}'
        dryrun.check_routes(tag, got, want[tag])
        launched[tag] = got[0]
        f64 = _dp_f64(dryrun.STEPS[tag][0], device)
        try:
            rows[tag] = dryrun.compare(tag, got[0], want[tag], f64,
                                       noise if tag == 'cls_bf16' else None)
        except AssertionError as e:    # every step's verdict, then raise
            bad.append(str(e))
            log(f'{tag0} {tag}: FAILED {e}')
            continue
        rows[tag]['collectives'] = json.loads(str(got[0]['launches']))[
            'collectives']
        if tag in control:
            rows[tag]['halves_apart'] = control[tag]
        log(f'{tag0} {tag}: {rows[tag]}')
    assert not bad, bad
    log(f'{tag0} two ranks on {backend}: every step within its gates, both '
        f'ranks equal, every kernel route of one process launched on each; '
        f'the ranks ran {ranks_wall:.1f} s, this process\'s references '
        f'beside them')
    shutil.rmtree(out, ignore_errors=True)
    return {'steps': rows, 'launches': _dp_launches(launched),
            'ranks_wall_s': ranks_wall}


def phase_dp_nccl_2(device):
    """[dp-nccl-2] [dp-gloo-2] under NCCL, one card a rank, where the
    machine has two cards; else it says why it did not run."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        log(f'[dp-nccl-2] not run: {n} CUDA device on this machine (NCCL '
            f'refuses two ranks on one card; [dp-gloo-2] ran them there)')
        return {'run': False, 'device_count': n}
    out = phase_dp_two(device, 'nccl')
    out['run'] = True
    return out


PARENT_SOURCES = {'fps.cu': {'fps': 'epn_fps'},
                  'ball_query.cu': {'ball_query': 'epn_ball_query'},
                  'ones_conv.cu': {'ones_conv': 'epn_ones_conv'},
                  'inter_conv.cu': {'fn': 'epn_inter_conv_mma',
                                    'f': 'epn_inter_conv_f',
                                    'fwd': 'epn_inter_conv',
                                    'f_f32': 'epn_inter_conv_f_f32'},
                  'inter_conv_bwd.cu': {'dtable': 'epn_inter_conv_bwd_table',
                                        'dg': 'epn_inter_conv_dg',
                                        'dw': 'epn_inter_conv_bwd_w',
                                        'dw_f32': 'epn_inter_conv_bwd_w_f32'},
                  'intra_conv.cu': {'intra_fwd': 'epn_intra_conv',
                                    'intra_df': 'epn_intra_conv_prenorm_df',
                                    'intra_dw': 'epn_intra_conv_bwd_w'}}


def load_parent(source, proc, so):
    """The earlier tree's C entries of ``source`` from its library, once
    nvcc is done (--parent-csrc)."""
    import ctypes
    from epn_pointcloud_tpu_torch.sampling_variants import parent_entry
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on the parent {source}:\n{out}')
    lib = ctypes.CDLL(so)
    for key, entry in PARENT_SOURCES[source].items():
        PARENT[key] = parent_entry(lib, entry, os.path.dirname(so))
    log(f'[build] parent {source} built and loaded')


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent-csrc', default=None,
                    help="an earlier tree's csrc/ directory: its bf16 "
                    'W-fused inter forward, W-off F, prenorm intra forward, '
                    'B6 df, fused dTable, W-off dG, fused dW and B6 dW, and '
                    'its fp32 W-fused inter forward, fused dTable, W-off dG, '
                    "fused dW, W-off F, intra forward, df and dW, its fps, "
                    "ball query and ones conv, timed beside this tree's")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port smoke run needs one',
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import epn_pointcloud_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: cannot import the port: {e}', file=sys.stderr)
        return 1
    from epn_pointcloud_tpu_torch import models
    from epn_pointcloud_tpu_torch.app.trainer import set_fp32_parity
    from epn_pointcloud_tpu_torch.ops import kernels

    set_fp32_parity()
    device = torch.device('cuda')
    t_start = time.time()
    try:
        if args.parent_csrc:
            from epn_pointcloud_tpu_torch.ops.kernels import build
            parents = [(src,) + build.compile_alone(
                os.path.abspath(args.parent_csrc), src,
                os.path.join(f'{WORK_DIR}_parent_{src[:-3]}', 'csrc'))
                for src in PARENT_SOURCES]
        timed('[build]', phase_build)
        if args.parent_csrc:
            for parent in parents:
                load_parent(*parent)
        model = models.build_model_from(full_opt(), seed=SEED).to(device).eval()
        results = timed('[compare]', phase_kernels, model, device)
        model_err = timed('[model]', phase_model, model, device)
        forward = timed('[forward]', phase_forward_time, model, device)
        torch.cuda.empty_cache()
        bf16_results = timed('[bf16]', phase_bf16_kernels, model, device)
        torch.cuda.empty_cache()
        bf16_model = timed('[bf16-model]', phase_bf16_model, model, device)
        bf16_forward = timed('[bf16-forward]', phase_forward_time, model,
                             device, dtype='bf16')
        del model
        torch.cuda.empty_cache()
        eval_counts, n_batches = timed('[eval]', phase_eval)
        bf16_counts, bf16_batches = timed('[bf16-eval]', phase_eval, 'bf16')
        results.update(timed('[backward]', phase_backward_kernels, device))
        torch.cuda.empty_cache()
        train_step = timed('[train]', phase_train_step, device)
        torch.cuda.empty_cache()
        counts, train_wall = timed('[train-entry]', phase_train_entry)
        torch.cuda.empty_cache()
        bf16_bwd = timed('[bf16-backward]', phase_backward_kernels, device,
                         'bf16')
        torch.cuda.empty_cache()
        bf16_train = timed('[bf16-train]', phase_bf16_train_step, device)
        bf16_train_counts, bf16_train_wall = timed(
            '[bf16-train-entry]', phase_train_entry, 'bf16')
        torch.cuda.empty_cache()
        inv_root = inv_tree()
        batches = inv_batches(inv_root, device, 3)
        legs = batches[0]
        inv_results, inv_routes = timed('[inv-kernels]', phase_inv_kernels,
                                        device, legs)
        torch.cuda.empty_cache()
        inv_train = timed('[inv-train]', phase_inv_train, device, batches)
        del batches
        inv_desc = timed('[inv-descriptor]', phase_inv_descriptor, device,
                         inv_root)
        inv_counts, inv_wall, inv_ckpt = timed(
            '[inv-train-entry]', phase_inv_train_entry, inv_root)
        torch.cuda.empty_cache()
        inv_bf16_results, _ = timed('[inv-bf16-kernels]', phase_inv_kernels,
                                    device, legs, 'bf16')
        torch.cuda.empty_cache()
        inv_bf16_train = timed('[inv-bf16-train]', phase_inv_bf16_train,
                               device, legs)
        del legs
        inv_bf16_desc = timed('[inv-bf16-descriptor]',
                              phase_inv_bf16_descriptor, device, inv_root)
        inv_bf16_counts, inv_bf16_wall, inv_bf16_ckpt = timed(
            '[inv-bf16-train-entry]', phase_inv_train_entry, inv_root,
            'bf16')
        torch.cuda.empty_cache()
        reg_b = reg_batch(reg_tree(), device)
        reg_results, reg_routes = timed('[reg-kernels]', phase_reg_kernels,
                                        device, reg_b)
        reg_fwd = timed('[reg-forward]', phase_reg_forward, device, reg_b)
        reg_train = timed('[reg-train]', phase_reg_train, device, reg_b)
        reg_bf16 = timed('[reg-bf16]', phase_reg_bf16, device, reg_b)
        del reg_b
        reg_entry = timed('[reg-entry]', phase_reg_entry)
        reg_bf16_entry = timed('[reg-entry] bf16', phase_reg_entry, 'bf16')
        eval3d = timed('[3dmatch-eval-entry]', phase_3dmatch_eval_entry,
                       inv_ckpt)
        eval3d_bf16 = timed('[3dmatch-eval-entry] bf16',
                            phase_3dmatch_eval_entry, inv_bf16_ckpt, 'bf16')
        torch.cuda.empty_cache()
        ref_conv = timed('[ref-convention]', phase_ref_convention, device)
        anchor = {}
        for tag in ANCHOR_MODELS:
            anchor[tag] = timed(tag, phase_anchor_model, tag, device)
        anchor_entry = timed('[ka20-entry]', phase_anchor_entry)
        # inv and reg below 60 anchors, the bf16 step below 60, dropout and
        # the entry points' last options
        inv_reg = {}
        for tag in ANCHOR_INV_REG:
            inv_reg[tag] = timed(tag, phase_anchor_inv_reg, tag, device,
                                 inv_root, reg_tree())
            torch.cuda.empty_cache()
        ka20_bf16 = timed('[ka20-bf16-train]', phase_ka20_bf16_train, device)
        dropout = timed('[dropout]', phase_dropout, device)
        options = timed('[option-entries]', phase_option_entries, inv_root,
                        reg_tree())
        torch.cuda.empty_cache()
        # xyz pooling, the ReLU in the kernels, the remaining heads and
        # modules
        pooling = timed('[pooling]', phase_pooling, device)
        torch.cuda.empty_cache()
        relu = timed('[relu]', phase_relu, device)
        torch.cuda.empty_cache()
        heads_prop = timed('[heads-propagation]', phase_heads_propagation,
                           device)
        torch.cuda.empty_cache()
        # data parallelism: a NCCL group of one in this process, then two
        # ranks on this card over gloo (and over NCCL on two cards)
        dp1 = timed('[dp-nccl-1]', phase_dp_nccl_1, device)
        torch.cuda.empty_cache()
        dp2 = timed('[dp-gloo-2]', phase_dp_two, device, 'gloo')
        dp2_nccl = timed('[dp-nccl-2]', phase_dp_nccl_2, device)
        for d in (REG_DIR, INV_DIR, EVAL_DIR, DP_DIR):
            shutil.rmtree(d, ignore_errors=True)
    except Exception:
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        'nvidia-smi unavailable'
    summary = []
    for k in kernels.KERNELS:
        # the numbers of the path that brought the kernel in: the fp32 inv
        # triplet step (b=16 a leg) for the W-off kernels, else the bf16
        # train step's backward (b=12), the bf16 forward (b=32), the fp32
        # forward (b=32) or the fp32 train step's backward (b=12);
        # `launches` from the main path (the --kanchor 20 train entry run),
        # else from the bf16 reg entry, the bf16 inv train entry run,
        # the fp32 inv train entry, the bf16 train entry,
        # the bf16 eval entry, the fp32 train entry
        rows = (inv_results[k.name] if k.name in _NO_WOFF else
                bf16_bwd.get(k.name) or bf16_results.get(k.name)
                or results[k.name])
        reg_bf16_launches = reg_bf16_entry['train_launches'][k.name]
        rec = {'name': k.name, 'route': 'cuda', 'source': k.source,
               'replaces': k.replaces,
               'launches': (pooling['step']['launches'][k.name]
                            or relu['bf16_step']['launches'][k.name]
                            or options['inv_train']['launches'][k.name]
                            or options['reg_train']['launches'][k.name]
                            or options['dropout_train']['launches'][k.name]
                            or anchor_entry['train_launches'][k.name]
                            or reg_bf16_launches or inv_bf16_counts[k.name]
                            or inv_counts[k.name]
                            or bf16_train_counts[k.name]
                            or bf16_counts[k.name] or counts[k.name])}
        rec.update(_aggregate(rows))
        if inv_bf16_results.get(k.name):
            # the bf16 inv triplet step's calls (b=16 a leg): for the W-off
            # kernels their bf16 build's record
            agg = _aggregate(inv_bf16_results[k.name])
            agg['share'] = agg['bound_ms'] / agg['ms']
            agg['launches'] = inv_bf16_counts[k.name]
            rec['bf16' if k.name in _NO_WOFF else 'inv_bf16'] = agg
        rec['phase'] = ('inv train step b=16 a leg' if k.name in _NO_WOFF
                        else 'bf16 train step b=12' if k.name in bf16_bwd
                        else 'bf16 forward b=32' if k.name in bf16_results
                        else 'fp32 forward b=32' if k.name in FWD else
                        'fp32 train step b=12')
        if k.name not in _NO_WOFF and inv_results.get(k.name):
            rec['inv'] = _aggregate(inv_results[k.name])
        if (k.name in bf16_bwd or k.name in bf16_results
                or k.name in F32_KERNELS) and k.name in results:
            rec['fp32'] = _aggregate(results[k.name])
        if k.name in F32_KERNELS and k.name not in _NO_WOFF:
            # the fp32 fused dW and dTable, the intra forward and dW: their
            # own CUDA-core kernel, in the cls step (b=12; the intra
            # forward: the b=32 forward) and the inv step (b=16 a leg);
            # launches from the fp32 train entries, all on it
            # (check_routes)
            for key, n in (('fp32', counts[k.name]),
                           ('inv', inv_counts[k.name])):
                rec[key].update(source=k.source, launches=n,
                                share=rec[key]['bound_ms'] / rec[key]['ms'],
                                **F32_KERNELS[k.name])
        elif k.name in F32_KERNELS:
            # the fp32 W-off dG and F (the record above: the inv step's)
            rec['fp32_kernel'] = dict(F32_KERNELS[k.name],
                                      share=rec['bound_ms'] / rec['ms'])
        if k.name == 'inter_conv':
            # the fp32 b=12 train step's forwards (phase 6)
            rec['fp32_train'] = _aggregate(results['inter_conv_train'])
        if k.name == 'intra_conv':
            # df runs this kernel (b=12 train step); ms above: b=32 forward
            rec['df'] = _aggregate(results['intra_conv_df'])
            rec['max_abs_err'] = max(rec['max_abs_err'],
                                     rec['df']['max_abs_err'])
        if reg_results.get(k.name):
            # the fp32 reg step's calls (b=8 pairs, 16 clouds)
            rec['reg'] = _aggregate(reg_results[k.name])
        rec.update({
            'reg_bf16_train_entry_launches': reg_bf16_launches,
            'reg_train_entry_launches': reg_entry['train_launches'][k.name],
            'reg_bf16_eval_launches': reg_bf16_entry['eval_launches'][k.name],
            'reg_eval_launches': reg_entry['eval_launches'][k.name],
            '3dmatch_bf16_eval_launches': eval3d_bf16['launches'][k.name],
            '3dmatch_eval_launches': eval3d['launches'][k.name]})
        # this slice's paths: the reference convention (cls, 60 anchors)
        # and the reduced-anchor cls models, b=32 forwards (fp32, bf16) and
        # the b=12 fp32 step; launches of the --kanchor 20 entry runs
        for key, res in (('ref_convention', ref_conv['results']),
                         *((tag.strip('[]'), anchor[tag]['results'])
                           for tag in ANCHOR_MODELS)):
            for part, rows in res.items():
                if rows.get(k.name):
                    agg = _aggregate(rows[k.name])
                    agg['routes'] = _route_table(
                        {k.name: rows[k.name]}).get(k.name)
                    rec.setdefault(key, {})[part] = agg
        rec.update({
            'ka20_train_entry_launches':
                anchor_entry['train_launches'][k.name],
            'ka20_eval_launches': anchor_entry['eval_launches'][k.name]})
        # inv and reg below 60 anchors (b=48 descriptors / b=8 pairs, and
        # their steps, fp32 and bf16), the ka20 cls bf16 step, the dropout
        # model's bf16 step and eval; launches of this slice's entry runs
        for key, res in ((*((tag.strip('[]'), inv_reg[tag]['results'])
                            for tag in ANCHOR_INV_REG),
                          ('ka20_bf16_train', ka20_bf16['results']),
                          ('dropout', dropout['results']))):
            for part, rows in res.items():
                if rows.get(k.name):
                    agg = _aggregate(rows[k.name])
                    agg['routes'] = _route_table(
                        {k.name: rows[k.name]}).get(k.name)
                    rec.setdefault(key, {})[part] = agg
        rec.update({f'{run}_entry_launches': options[run]['launches'][k.name]
                    for run in ('inv_train', 'inv_eval', 'reg_train',
                                'reg_eval', 'dropout_train')})
        # xyz pooling (b=32 forwards of both modes in both dtypes, the b=12
        # fp32 step), the ReLU model (b=32 bf16 eval, b=12 steps) and the
        # ClsOutBlockR head's intra conv; launches of each path's run
        for key, res in (('pooling', pooling['results']),
                         ('relu', relu['results']),
                         ('heads', heads_prop['results'])):
            for part, rows in res.items():
                if rows.get(k.name):
                    agg = _aggregate(rows[k.name])
                    agg['routes'] = _route_table(
                        {k.name: rows[k.name]}).get(k.name)
                    rec.setdefault(key, {})[part] = agg
        rec.update({
            'pooling_step_launches': pooling['step']['launches'][k.name],
            **{f'pooling_{m}_{d}_launches':
               pooling[f'{m}_{d}']['launches'][k.name]
               for m in POOLINGS for d in ('fp32', 'bf16')},
            'relu_bf16_eval_launches': relu['eval_launches'][k.name],
            'relu_fp32_step_launches': relu['fp32_step']['launches'][k.name],
            'relu_bf16_step_launches': relu['bf16_step']['launches'][k.name],
            'heads_launches': heads_prop['ClsOutBlockR']['launches'].get(
                k.name, 0)})
        # data parallelism, by step: the NCCL group of one (cls fp32 and
        # bf16, inv fp32) and rank 0 of the two gloo ranks (cls fp32 and
        # bf16, inv and reg fp32, each on half its global batch)
        rec.update({'dp_nccl1_launches': dp1['launches'].get(k.name, {}),
                    'dp_gloo2_launches': dp2['launches'].get(k.name, {})})
        rec.update({'inv_bf16_train_entry_launches': inv_bf16_counts[k.name],
                    'inv_train_entry_launches': inv_counts[k.name],
                    'bf16_train_entry_launches': bf16_train_counts[k.name],
                    'bf16_eval_launches': bf16_counts[k.name],
                    'eval_launches': eval_counts[k.name],
                    'train_entry_launches': counts[k.name]})
        summary.append(rec)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_results.json'), 'w') as f:
        json.dump({'card': card, 'device': torch.cuda.get_device_name(0),
                   'torch': torch.__version__, 'cuda': torch.version.cuda,
                   'batch': BATCH, 'train_batch': TRAIN_BATCH,
                   'per_layer': results, 'bf16_per_layer': bf16_results,
                   'model_b8_max_abs_err': model_err, 'bf16_model': bf16_model,
                   'forward_b32': forward, 'bf16_forward_b32': bf16_forward,
                   'train_step_b12': train_step,
                   'eval_batches': n_batches, 'eval_launches': eval_counts,
                   'bf16_eval_batches': bf16_batches,
                   'bf16_eval_launches': bf16_counts,
                   'train_launches': counts, 'train_entry_wall_s': train_wall,
                   'bf16_backward_per_layer': bf16_bwd,
                   'bf16_train_step_b12': bf16_train,
                   'bf16_train_launches': bf16_train_counts,
                   'bf16_train_entry_wall_s': bf16_train_wall,
                   'inv_per_layer': inv_results, 'inv_routes': inv_routes,
                   'inv_train_step_b16': inv_train,
                   'inv_descriptor_b48': inv_desc,
                   'inv_train_launches': inv_counts,
                   'inv_train_entry_wall_s': inv_wall,
                   'inv_bf16_per_layer': inv_bf16_results,
                   'inv_bf16_train_step_b16': inv_bf16_train,
                   'inv_bf16_descriptor_b48': inv_bf16_desc,
                   'inv_bf16_train_launches': inv_bf16_counts,
                   'inv_bf16_train_entry_wall_s': inv_bf16_wall,
                   'reg_per_layer': reg_results, 'reg_routes': reg_routes,
                   'reg_forward_b8': reg_fwd, 'reg_train_step_b8': reg_train,
                   'reg_bf16_b8': reg_bf16, 'reg_entry': reg_entry,
                   'reg_bf16_entry': reg_bf16_entry,
                   '3dmatch_eval': eval3d, '3dmatch_bf16_eval': eval3d_bf16,
                   'ref_convention': ref_conv, 'reduced_anchors': anchor,
                   'ka20_entry': anchor_entry,
                   'inv_reg_below_60': inv_reg, 'ka20_bf16_train': ka20_bf16,
                   'dropout': dropout, 'option_entries': options,
                   'pooling': pooling, 'relu': relu,
                   'heads_propagation': heads_prop,
                   'dp_nccl1': dp1, 'dp_gloo2': dp2, 'dp_nccl2': dp2_nccl,
                   'phase_wall_s': PHASE_WALL,
                   'kernels': summary, 'seconds': time.time() - t_start},
                  f, indent=1)
    log(f'[done] {time.time() - t_start:.1f} s')
    print(json.dumps({'kernels': summary}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
