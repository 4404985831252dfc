#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card: TransFusion-L, the
full MSMDFusion flagship, the flagship's train step, then the flagship's
inference and train step on the two other sparse-conv engines, its bf16
compute frames, its ablation and backend switches, its train step with
the image branch trained, TransFusion-L's train step, the flagship's
stage-2 step with its LiDAR encoders frozen and its bf16-compute train
step, TransFusion-LC's inference and train step, the Waymo
TransFusion-L and LC, the eval and train CLIs on files, the flagship's
step and CLIs over process groups, TransFusion-L's stage-1 recipe (GT
paste from a GT database the port's tool builds), the Waymo configs
from KITTI-format files, the offline tools (FLOP counts, conv-BN
folding, the sparse-conv microbench, the speed CLI, the trace summary,
checkpoint publishing, visualization and log analysis) and the
single-stage LiDAR zoo (CenterPoint, PointPillars, SECOND, dynamic SECOND,
FreeAnchor), from tensors and through the CLIs from files, then Part-A2,
MVXNet and test-time augmentation, then the point-based zoo (VoteNet,
H3DNet, SSD3DNet, ImVoteNet; VoteNet also through the CLIs from files).

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a non-zero exit):

1. environment: the card's name and power limit (``nvidia-smi``); TF32 off
   for cuDNN and matmul, so every float32 product is full float32;
2. build: every kernel under ``msmdfusion_torch/csrc`` with one ``nvcc``
   process per source, all started together, into
   ``msmdfusion_torch/_build/``; then the kernels' card tests
   (``tests/test_torch_rows_card.py``, ``tests/test_torch_conv_bf16_card.py``,
   ``tests/test_torch_conv_x3_card.py``,
   ``tests/test_torch_match_conv_card.py``,
   ``tests/test_torch_conv_dw_card.py``,
   ``tests/test_torch_nn_argmin_card.py``,
   ``tests/test_torch_conv_ffma_card.py``,
   ``tests/test_torch_zoo_card.py``, ``tests/test_torch_indoor_card.py``:
   JAX-free, every test must pass) in a child process;
3. TransFusion-L: ``configs/transfusion_nusc_voxel_L.py`` at full width
   (1440 x 1440 x 41 grid, 160k voxel capacity, the flagship's measured
   encoder stage capacities), weights drawn from a seed, one 250k-point
   synthetic frame, batch norms calibrated on it. The path below runs on
   it;
4. MSMDFusion: ``configs/MSMDFusion_nusc_voxel_LC.py`` with the
   capacities of the JAX package's ``_flagship_model('full')`` (voxels,
   encoder, GMA downscale, GMA union and foreground voxels), weights from
   a seed, and the JAX package's realistic scene (``realistic_batch``:
   250k points, six 448 x 800 cameras, 20000 foreground points and 15000
   real pixels per camera). The same path runs on it; then one counted
   frame on the exact fp32 product (``MSMD_CONV_GEMM=highest``, set around
   it only: launches 16/37/8/3 with kernel ``gather_gemm_conv``) and how
   far the default x3 path lies from it (printed, not held); two fp32
   forwards give bit-equal voxel features (the voxel mean's fixed-order
   segment sum; the dense heatmap's difference is printed); then the
   dense layers new to this model are timed on and off cuDNN, in fp32 and
   in bf16;
5. the MSMDFusion train step on the same model and scene, with the
   scene's ground truth: the reference's stage-2 recipe (frozen
   ``img_backbone``/``img_neck``, AdamW lr 1e-4 and weight decay 0.05,
   global-norm clip 10, step schedule with linear warmup), dropout from a
   seeded generator. One step records the arguments of every
   ``rows_queries``, ``conv_dw`` and backward ``gather_gemm_conv`` call
   (kernels ``conv_dw_x3`` and ``gather_gemm_conv_x3``); each is held
   against its plain versions (rows equal; ``dw`` and ``d_feats`` elements
   within 1e-4 of the magnitude of their sums, against the x3 plain
   version and the exact one) and timed alone, and run again on the exact
   (FFMA) kernels, held to the exact plain version and timed. The same step on the plain versions, on the kernel path's
   proposals, assignment, dropout masks, head-input gradient and ReLU
   masks (at full scale every layer has ReLU inputs within rounding of 0,
   and a free ReLU there moves a gradient by up to a few percent of its
   largest value, the kernel path against itself included): the
   dense-heatmap loss and every parameter gradient below the head within
   1e-4 of their largest value, the decoder's losses, the head-input
   gradient and the head's parameter gradients within 10 times the plain
   path's own spread under reordered sums. Then one counted step through
   ``apis.train.make_train_step`` (launches of all six kernels asserted,
   no row dropped), five timed AdamW steps after a warm-up (forward with
   the auction timed apart, backward, optimizer; finite losses; the
   trainable parameters move, the frozen image branch does not), the
   backward on and off cuDNN, and a profile with the idle share. The
   plain path of phases 4-5 (the twin) computes the x3 product where the
   kernels do (``X3Plain``) and, as phase 6 pins its bf16 rounding, takes
   the kernel path's conv operands wherever its own lie within 2^-16 of
   their binade of them (``PinnedRounding``): the same split, sums in
   another order;
6. the packed bf16 engine (``MSMD_CONV_DTYPE=bfloat16``, set around this
   phase only: the JAX package's benchmarked setting) on the same model
   with its calibrated weights: the path below with every conv call on
   kernel ``gather_gemm_conv_bf16`` held against its plain version (which
   rounds the same operands, so the per-element rule holds), the launches
   (16/37/8/3), and the all-plain twin held to 10 times the plain path's
   reordered spread up to the head too (bf16 rounding of every conv's
   input turns fp32 ulps into bf16 ulps); how far its head input and boxes
   lie from phase 4's fp32 path (printed, not held); then phase 5's
   train step with every ``conv_dw_bf16`` and backward-conv call held to
   1e-4 of its sums, the twin, a counted step (launches 16/8/73/37/8/3)
   and 3 timed steps. Every packed call must carry its plan's row order
   (``matchconv.RowOrder``); its line prints the useful share (hits over
   the row-taps or pairs the kernel stages) and its time over the fp32
   engine's kernel's (x3) on the same call in phase 4 or 5
   (``fp32_ratio``);
7. the one-hot engine (``MSMD_CONV_ALGO=onehot``): no rulebook rows, every
   conv matches its plan's queries inside its kernel, on the x3 product
   by default (kernel ``match_conv_x3``): the path below with every call
   held to its x3 plain version and the exact one, run again on the exact
   (FFMA) kernel ``match_conv`` under ``MSMD_CONV_GEMM=highest`` (set
   around that call only: ``ffma_ratio``), with its useful share (hits
   over the row-taps the kernel stages with each block's rows sorted by
   tap-hit mask), launches (37/8/3, no rows kernel), the twin on the
   x3 plain versions with the x3 split pinned as in phases 4-5, and
   ms/frame; one counted frame on ``highest`` (launches 37/8/3 with
   ``match_conv``); then ``match_conv_bf16``, the bf16-feature mode, on
   the frame's 37 calls with their features rounded to bf16
   (``match_bf16_calls``: its path's launches, each call within
   one bf16 ulp of the plain bf16 version plus 1e-4 of its sum's
   magnitude and bit-equal to it on at least ``BF16_EQUAL`` of its
   elements, timed); then the train step with the forward and backward
   ``match_conv_x3`` calls (held and timed as above), the 37
   ``rows_affine`` calls that build each conv's ``dw`` rows in the
   backward and the exact ``conv_dw`` (the one-hot ``dw`` stays exact
   whatever ``MSMD_CONV_GEMM``, as the JAX package's ``HIGHEST``
   ``_dw_from_rows`` is) against their plain versions (each exact
   ``conv_dw`` line, here and in phase 5's reruns, also prints its useful
   share, the hits over the row-taps the kernel multiplies, and
   ``sgemm_ms``: cuBLAS fp32 ``torch.bmm``, TF32 off, of the same per-tap
   products on operands gathered beforehand, a yardstick of the FFMA
   rate that the port never calls), a counted step
   (launches 37/73/37/8/3) and 2 timed steps. Last, the engines' frames
   interleaved (fp32 x3, fp32 highest, packed, one-hot x3: one of each per
   round, 6 rounds), the frame and its stage ``plans`` per engine, so that
   a slow stretch of the host falls on all of them (after phases 8-10);
8. the flagship under ``compute_dtype='bfloat16'`` (the JAX package's
   ``MSMD_BF16``: images and LiDAR voxel features cast to bf16, every layer
   after them in the dtype the JAX layer produces) on the calibrated
   weights, three frames (``BF16``): parameters cast to bf16 as the JAX
   bench casts them (``layers.cast_params``; the norms' statistics stay
   fp32, checked) under the packed engine, the JAX bench's setting with
   ``MSMD_BF16``, and under the one-hot engine (``match_conv_bf16`` on
   the 25 convs with bf16 features: its first model path), and fp32
   parameters on the default x3 route. Each: every conv call on bf16
   features held to its plain version (the same single rounding to bf16)
   by phase 7's bf16 rule and timed; launches; no row dropped; the sparse
   encoder's output bf16, predictions and boxes fp32 and finite; the
   twin (kernel path vs all-plain path on the kernel path's proposals,
   every output, the head input and the dense heatmap too, within 10
   times the plain path's own spread under reordered sums, never less
   than 1e-4 of max: no bf16 rounding is pinned); how far it lies from
   phase 4's fp32 path (printed); ms/frame, stages, a profile;
9. one frame each under ``MSMD_GMA_NN=exact`` (every ``masked_nn`` call, a
   stage's camera voxels against all its LiDAR voxels, held bit-equal to
   its plain version and timed; 4 launches), ``MSMD_GMA_DUMMY=random:7``,
   ``MSMD_FUSE_BN=0`` (the head input within 1e-4 of max of the fused
   frame's) and ``MSMD_SPARSE_BACKEND=xla`` (no kernel launched): launches,
   no row dropped, finite boxes, ms/frame;
10. the train step with the image branch trained (``freeze_img=False``):
   every parameter in the optimizer, the ResNet's norms on their running
   statistics; one counted step (phase 5's launches), 3 timed steps,
   finite losses, the image parameters moved and the ResNet's statistics
   unchanged, peak memory;
11. TransFusion-L's stage-1 step on phase 3's model and frame with its
   config's recipe (``TL_TRAIN``: AdamW, weight decay 0.01, clip 0.1, the
   cyclic schedule; the train-time voxel capacity ``max_voxels[0]`` =
   120,000, below the frame's voxels, so the counted step drops exactly
   the difference at ``voxelize.mean_batch.voxel_cap`` and nothing
   elsewhere): phase 5's path (``drive_train``: every ``rows_queries``,
   backward ``gather_gemm_conv_x3`` and ``conv_dw_x3`` call held to its
   plain versions, the all-plain twin to phase 5's limits, launches
   8/4/41/21, 3 timed steps);
12. the flagship's stage-2 step as its config states it: ``freeze_img``
   and ``freeze_lidar_components`` (``apis.train.frozen_prefixes``): one
   counted step (phase 5's launches: the frozen encoder's backward runs
   for ``grad_norm``), 2 timed steps; the frozen modules' parameters and
   statistics bit-equal afterwards, ``grad_norm`` above the clip's norm
   of the trainable gradients;
13. the bf16-compute train step with fp32 parameters (the JAX bench's
   ``MSMD_BF16`` train) on packed, x3 and one-hot (``BF16_TRAIN``): every
   backward conv call on bf16 rows held to its plain version by phase 8's
   rules (``match_conv_bf16``'s ``d_feats`` over the dual plans by the
   bf16 rule: its first backward path), every ``conv_dw`` on bf16 operands
   as an fp32 call on the widened ones; the all-plain twin with every loss
   and gradient within 10 times the plain path's own spread (never less
   than 1e-4 of max); a counted step (launches, the backward's apart),
   overflow 0, bf16 encoder activations, fp32 gradients, 2 timed steps;
14. TransFusion-LC (``configs/transfusion_nusc_voxel_LC.py``) on phase
   3's weights (kept before phase 11 trains them; the image branch and
   the head's image fusion drawn from the seed, their norms calibrated)
   and frame with six 448 x 800 cameras in the reference's view order
   (``synth_scene.lc_batch``): without images its outputs are phase 3's;
   the new dense layers on and off cuDNN; the path on it (launches 8/21,
   no row dropped, the twin to phase 3's limits, the proposals checked
   on the heatmap the head picks them from: ``Selection``); the share of
   proposals on an image and the image stages' ms;
15. its step under ``freeze_img`` with its config's recipe (phase 11's
   launches and configured drop): the image branch's parameters and
   statistics bit-equal, its norms in eval mode, its gradients nonzero
   and in ``grad_norm`` (the JAX detector stops none), 2 timed steps;
16. Waymo (``configs/transfusion_waymo_voxel_{L,LC}.py``) on a 180,000-
   point frame over its range with five 448 x 800 cameras: the encoder's
   strided outputs measured with open capacities and held to ``WAYMO``'s;
   TransFusion-L's path (as phase 3's, 7-wide boxes); the LC model on its
   weights (without images its outputs; a counted frame, the share on an
   image, ms/frame); one TransFusion-L step with the config's recipe
   (``drive_train``: its per-call checks, phase 11's launches; no twin,
   see ``WAYMO``);
17. the system's own entry points on files: a nuScenes-layout dataset of
   4 full-size samples in a temporary directory (``write_nuscenes``: each
   a realistic 250k-point frame split over its keyframe ``.bin`` and 9
   sweeps, six 900 x 1600 uint8 ``.npy`` views in ``CAM_ORDER`` with the
   rig's calibration, the MDU ``.pkl.npy`` artifacts of its objects, its
   GT, an info ``.pkl``; no PIL), a checkpoint of the seed's weights with
   norms calibrated on sample 0, then the eval CLI
   (``msmdfusion_torch.tools.test``) on the flagship config with
   ``FLAGSHIP``'s capacities through ``--cfg-options``, ``--out --eval
   bbox``: launches 16/37/8/3 a frame, overflow 0, the metrics' keys,
   sample 0's detections bit-equal to ``model.get_bboxes(model(...))`` on
   the same batch; the pipeline's ms per sample alone (1 worker and the
   config's ``workers_per_gpu``), the model's ms/frame, the CLI's frames/s
   (``ENTRY``: a pass over an info file listing the 4 samples 40 times;
   the pipeline alone on 8 of them with 1 worker);
   ``--format-only`` and the submission's schema; the train CLI
   (``tools.train``) on the config's stage-2 recipe under CBGS, its two
   samples a batch at twice the capacities, 3 steps, one val frame
   (launches of phase 5 a step plus one frame's), finite losses in the
   JSON log, the checkpoint and TensorBoard files; a resume at step 3
   that replays epoch 0's first batch; the eval CLI loading that
   checkpoint with every tensor bit-equal to the state after step 3; no
   worker process left;
18. the flagship data-parallel (``DIST``), each part in child processes
   (the main process joins no group): (a) phase 5's step (``FLAGSHIP``'s
   capacities times 4; phase 17 trains at 3x) on the first frame of a
   realistic batch of two (4x: the encoder's and the GMA's capacities
   hold the batch), through ``make_train_step`` in a world-1 NCCL
   group (``parallel.init_dist('manual')``), against the single-process
   step on that frame; (b) the batch of two split over two ranks that
   share the card over gloo (NCCL refuses two ranks on one card; where
   there are two cards, over NCCL on both as well), one frame a rank, the
   config's dropout on, against the single-process step on both frames.
   Each split step runs on the reference step's proposals, assignment
   and ReLU masks on inputs with a batch axis (``PinnedProposals``,
   ``PinnedTargets``, ``BatchReluMasks``: discrete functions of the
   values, which rounding can turn at a near-tie), each rank on its
   share; the sparse rows' ReLUs decide for themselves. Held in each: the loss terms, ``grad_norm``, every gradient and
   running statistic within 10 times the spread of the single-process step
   under reordered sums (``Reordered``: the norms' moments summed in
   another order, the dense convs off cuDNN, the perturbation a split
   brings; on the same pins), never less than 1e-4 of max (phase 5's twin
   limit); each parameter's update within 1e-3 of the learning rate (2.01
   times it where the gradient's sign is unsettled or its clipped value
   near Adam's eps) plus 4 ulp of the parameter; phase 5's launches and
   overflow 0 on every rank; every rank ends with the same bits; the
   collectives of a step counted; ``grad_norm``'s largest parts printed;
   2 steps timed on each side. (c) The eval CLI on phase 17's files under
   ``msmdfusion_torch/tools/dist_test.sh``
   (torchrun, ``--launcher pytorch``, 2 ranks on the card over gloo): the
   merged detections in dataset order, each bit-equal to phase 17's
   single-process output, overflow 0. (d) The train CLI over 2 ranks
   (``--launcher manual``, gloo, one sample a rank): 1 step and
   ``ckpt_1``, written by rank 0 alone, equal to both ranks' tensors; a
   resume to step 2 (epoch 0 again from its first batch), ``ckpt_2`` equal
   to both ranks. A ``dist`` line sums up each part's worst deviation
   against its limit, the collectives of a step and its seconds;
19. GT paste (``gt_paste``, on phase 17's files, before phase 18 (a, b)):
   three other frames of the same generator (seeds 1-3) in the nuScenes
   layout under the config's ``db_sampler.data_root`` of the working
   directory, ``python -m msmdfusion_torch.tools.create_data nuscenes
   --with-gt-database`` (in-process; without nuscenes-devkit, from the
   info file already there) builds the database the config reads
   (``nuscenes_dbinfos_train.pkl``); the train CLI on
   ``configs/transfusion_nusc_voxel_L.py`` unchanged but for the encoder
   capacities (``GT_PASTE``): its ``ObjectSample`` pipeline in the
   loader's workers, the ``cyclic`` schedule, x3, 3 steps and a val frame:
   the (objects, points) pasted in every sample of every step above 0
   (the batches' ``gt_paste`` metas), launches of kernels 1, 2 and 4 a
   step (phase 11's) plus the val frame's, finite losses, overflow 0 at
   every site but the config's train-time voxel cap (its drop printed);
   then the fade: the same train set with ``stop_epoch`` 1 through one
   loader on 2 worker processes, epoch 0's first batch pasting in every
   sample and epoch 1's in none;
20. Waymo from files (``waymo_files``): phase 16's frame as a KITTI-format
   Waymo set (``write_waymo``: 6-float velodyne ``.bin``, infos with
   ``point_cloud.velodyne_path``, ``image.image_idx``, a calibration that
   is not the identity, camera-frame annos with ``num_points_in_gt`` and
   a DontCare entry) under the configs' ``data_root`` of the working
   directory; the train CLI on ``configs/transfusion_waymo_voxel_L.py``
   unchanged but for the encoder capacities (3x ``WAYMO``'s for the
   batch of two augmented frames), ``load_interval`` keeping a batch a
   step, 2 steps (phase 11's launches a step, overflow 0 at every site,
   finite losses); the eval CLI ``--eval`` on a checkpoint of the seed's
   weights with norms calibrated on val frame 0 (launches, overflow 0,
   finite ``waymo`` metrics, sample 0's boxes bit-equal to a direct
   forward on its pipeline output, the model's ms/frame), a timed pass
   (the eval CLI over an info file listing the frame 40 times: its
   steady frames/s from frame 2 x workers on, and the pipeline alone at
   the config's workers), ``--format-only`` (the
   ``.bin`` parses back to as many objects as were detected), and the
   eval CLI on ``transfusion_waymo_voxel_LC.py`` (no views in its
   pipeline: its detections bit-equal to TransFusion-L's on the same
   weights);
21. the offline tools (``offline_tools``, after phase 20; (f) inside
   phase 17's working directory, after phase 19): (a)
   ``apis.flops_counter.count_flops`` on phase 4's calibrated flagship
   frame and phase 3's TransFusion-L frame, on the kernels and on their
   plain versions (``kernels.plain_kernels``): the same integers, op by
   op; GFLOP a frame, the sparse convs' share, the TFLOP/s of the fp32
   frame timed again (CUDA events, 5 frames); (b)
   ``tools.misc.fuse_conv_bn`` on the flagship's calibrated weights saved
   as a checkpoint: ``FUSED_PAIRS`` pairs folded (the CPU test's count),
   a kernel-path frame of the fused model against the unfused one on the
   exact product (``MSMD_CONV_GEMM=highest``, where the fold changes
   roundings alone), the head input within 1e-4 of max and the proposals
   by the plain-path rule (``check_proposals``); on the default x3
   product the same distances printed, not held (the fold moves every
   folded weight's bf16 hi/lo split); (c)
   ``tools.analysis_tools.conv_microbench`` at full shapes, all eight
   configs, every conv line's minimum at or above its bound; (d) the
   speed CLI (``tools.analysis_tools.benchmark``) on
   ``configs/transfusion_nusc_voxel_L.py`` at 200,000 points; (e) a
   flagship frame traced by ``utils.profiling.trace`` and summarized by
   ``tools.analysis_tools.trace_summary``: its device total within 10% of
   ``profile_forward``'s busy ms of a frame, one ``extract_pts_feat``;
   (f) ``publish_model`` on the train CLI's checkpoint (no optimizer,
   loads, its tensors equal), ``visualize_results`` on the eval CLI's
   ``--out`` pickle and ``analyze_logs`` on the train CLI's logs;
22. the single-stage zoo (``zoo``, after phase 21; (f) inside phase 17's
   working directory, after phase 21 (f)), each config at its own widths
   and capacities with seed-0 weights and norms calibrated on its frame
   (``ZOO``): (a) ``configs/centerpoint_nusc_voxel.py`` on phase 3's
   250,000-point frame, (b) ``pointpillars_nusc.py`` on the same frame,
   (c) ``second_kitti.py`` (``conv_module`` encoder) and (d)
   ``dynamic_voxelnet_kitti.py`` on a 40,000-point KITTI-range frame, (e)
   ``free_anchor_nusc.py`` on (b)'s frame. Each inference frame
   (``zoo_frame``; (a)-(d)): launches (TransFusion-L's 8/21 for (a),
   8/12 for (c) and (d), none for (b)), the rows each cap drops printed
   per site, finite boxes, every NMS call run again on the CPU on the
   same inputs (the same keep set and order; pairs within ``NMS_NEAR`` of
   their threshold counted, not held), two forwards and decodes
   bit-equal, 10 frames timed by CUDA events; on (a) and (c) the kernel
   path against the all-plain twin (``zoo_twin``: the x3 product, its
   rounding pinned, the kernel path's top K decoded on both): the head
   input within 1e-4 of max, the head's outputs and the decoded
   candidates within 10x the plain path's spread under reordered sums.
   Each train step (``zoo_step``; (a), (b), (c), (e)): the config's
   optimizer and schedule, one counted step (launches: TransFusion-L's
   step's for (a), 8/4/23/12 for (c); the train-time caps' drops printed
   per site), finite losses, 3 steps timed at their seams. (f)
   CenterPoint through the eval CLI over phase 17's samples (its
   frames/s) and 2 train-CLI steps; (g) SECOND through both CLIs on a
   KITTI-format set of (c)'s frame (``write_waymo(..., prefix='kitti',
   columns=4)``).
23. the two-stage and fusion zoo (``two_stage``, after phase 22;
   ``TWO_STAGE``) on (c)'s 40,000-point KITTI frame at the configs'
   widths and capacities: (a) Part-A2 (``configs/parta2_kitti.py``: the
   U-Net, RoI-aware pooling, the RoI head's dense 3-D convs on cuDNN)
   with outputs ``rois`` [1, 100, 7] and RPN maps 200 x 176; the U-Net
   decoder's four convs (inputs 128/96/48/32 wide) and their plans' rows
   held to their plain versions and timed; ``zoo_frame`` (launches
   12/16, rows dropped per site, NMS against the CPU, the twin on the
   kernel path's top K and RoIs: the RPN's input and the U-Net's
   full-resolution features within 1e-4 of max, the RPN's maps and
   candidates, the semantic branch and the RoI head's outputs within 10x
   the reordered spread; two forwards bit-equal, 10 frames by CUDA events,
   stages ``voxelize``/``plans``/``convs``/``unet_decoder``/``bev``/
   ``rpn``/``roi_pool``/``roi_head``/``decode``); one frame each under
   ``MSMD_CONV_DTYPE=bfloat16`` (12/16 on ``gather_gemm_conv_bf16``,
   twin at phase 6's limit) and ``MSMD_CONV_ALGO=onehot`` (16
   ``match_conv_x3``, twin at phase 7's); (b) its train step
   (``zoo_step``: 12/4/31/16, 3 steps split at their seams, each from
   the calibrated weights: after one update of the recipe on the seed's
   weights the next step's RoIs overflow the corner loss); (c) MVXNet
   (``configs/mvxnet_kitti.py``) with one seeded 384 x 1248 view whose
   lidar2img is KITTI's published P2 after the velodyne-to-camera axis
   swap: the first sparse conv's taps (27, 128, 16), the share of voxel
   centres on the image, conv_input (128 -> 16) and its plan held and
   timed, ``zoo_frame`` (8/12, stages with ``img`` and ``fusion``); (d)
   its step (8/4/24/12); (e) ``aug_test_detector`` over phase 3's
   TransFusion-L and frame on ``MultiScaleFlipAug3D``'s 4 views
   (horizontal x vertical flip, scale 1): 4 frames' launches, boxes
   before and after the circle-NMS merge, two runs bit-equal, ms per
   merged frame. Each path's launches go into the ``kernels`` line's
   ``path_launches``.
24. the point-based zoo (``point_zoo``, after phase 23; ``POINT_ZOO``) at
   the configs' widths: (a) VoteNet (``configs/votenet_scannet.py``) on a
   seeded ScanNet-like room (``synth_scene.indoor_room``: a floor, walls,
   12 pieces of furniture of the 18 classes) through the config's test
   pipeline (40,000 points with the height channel); (b) H3DNet
   (``configs/h3dnet_scannet.py``) on the same room; (c) SSD3DNet
   (``configs/ssd3d_kitti.py``) on phase 22's KITTI frame sampled to
   16,384 points; (d) ImVoteNet (``configs/imvotenet_sunrgbd.py``) on a
   SUN RGB-D-like room (20,000 points) in front of a seeded pinhole
   (``pinhole``: K and a pitched Rt) with a seeded 530 x 730 image and 8
   2-D boxes (6 projected from the objects, 2 padded invalid): the cue
   path, then the ResNet-50 + FPN path (one frame). Each frame
   (``point_frame``): no launch of the six kernels, ``overflow_total``
   0, finite boxes, the host's synchronisations a frame, two forwards
   and decodes bit-equal, the port's own CPU run on the same weights and
   inputs (``point_twin``: how many of the CPU's FPS, ball-query, kNN and
   VoteFusion top-k choices differ from the card's, with the ball
   query's differing slots' distance from the radius; then with the
   card's pinned into it, ``PinnedPoints``, every output within 1e-4 of
   max), 10 frames by CUDA events and the stages ``sa``/``fp``/``vote``/
   ``aggregation``/``head``/``decode`` (``fps`` and ``ball_query``
   inside them; ``primitives``/``refine`` for H3DNet, ``img`` for
   ImVoteNet) with the FPS loop's ms by CUDA events and by the host
   clock; each step (``point_step``, batch 2, the config's AdamW and
   clip): no launch, overflow 0, finite losses, 3 steps split at their
   seams. (e) VoteNet through the train CLI (2 steps of 8 samples) and
   the eval CLI (2 samples, the indoor mAP and mAR at 0.25 and 0.5) on a
   ScanNet-layout set of two rooms (``write_scannet``: 6-float points,
   instance and semantic masks, infos), and a SUN RGB-D-layout info file
   (``write_sunrgbd``) read through ``SUNRGBDDataset``.

Each phase prints its seconds by the host clock.

Batch norms are calibrated on each model's frame first
(``utils/calibrate.py``: running statistics set to those of each norm's
input, as a trained checkpoint's roughly are), so that activations keep
a realistic scale; with random statistics the flagship's gated GMA
features grow to ~1e8 and a tolerance scaled by the largest value would
pass a kernel that corrupts the small rows.

The fp32 rulebook engine runs its default ``x3`` route throughout
(``MSMD_CONV_GEMM`` unset): kernels ``gather_gemm_conv_x3`` and
``conv_dw_x3``, with launches 8/21 (TransFusion-L), 16/37/8/3 and
16/8/73/37/8/3; every call of theirs is held to its x3 plain version and
to the exact one, and run again on the exact (FFMA) kernel
``gather_gemm_conv``/``conv_dw`` under ``MSMD_CONV_GEMM=highest`` (set
around that call only), held to the exact plain version and timed
(``ffma_ratio``: the x3 time over the FFMA time). Each exact conv rerun
(``gather_gemm_conv``, and phase 7's ``match_conv``) also prints its
useful share (hits over the row-taps it multiplies: each tap's hits in a
128-row block in whole 16-row slices, ``ffma_multiplied``) and
``sgemm_ms``: the sum over taps of cuBLAS fp32 ``torch.mm``, TF32 off, on
each tap's hit rows gathered beforehand, a yardstick of the FFMA rate at
these shapes that the port never calls.

The path, per model: one forward records the arguments of every kernel
call; each call is held against the kernel's plain version (rows,
nearest neighbours and row gathers equal; each conv element within 1e-4
of the magnitude of its own sum, and the whole output within 1e-4 of its
largest value; each row gather also at C - 1 columns, the kernel's
per-element path) and timed alone by CUDA events over back-to-back
calls (each rows line also prints the device's time alone of the kernel
and of ``torch.searchsorted``, ``device_ms``, the kernel's ratio to
searchsorted by both, the bytes its design reads, the largest key window
and the share of windows in tiles that overflow the block's buffer);
launch counts
are set to 0, one forward + decode runs, and the counts are read and
asserted; boxes must be finite, scores in [0, 1], no row dropped at any
capacity; the kernel path once more, keeping its conv operands
(``PinnedRounding``), and the same forward on the plain versions,
replaying them and decoding that kernel forward's proposals
(``PinnedProposals``: its cells, kept by the local-max NMS), must agree
within 1e-4 of max up to the head's decoder (the head's input and the
dense heatmap), and after it (decoder outputs, boxes; a box's yaw through
the head's ``rot``, of which it is the angle) within 10 times the plain
path's own spread under reordered sums (never less than 1e-4): the
decoder's attention amplifies rounding (how far the counted forward lies
from the replayed one is printed: the x3 and packed routes turn ulp-level
run-to-run noise into rounding steps); the proposals must be the head's
own choice on a heatmap within 1e-4 of max of the plain one
(``check_proposals``: the kernel path's); then per-stage CUDA-event times,
ms/frame, frames/s, peak memory and a profile with the device's idle
share.

Before it, the rows kernels' sums on the packed engine's frame and step
(with masks) and on the one-hot step's backward. The line before the
last is ``{"kernels": [...]}``: per kernel its
launches, its largest error against the plain version, its time, the
plain version's, its bound and a library call's, each time the sum over
the path's calls, and ``path_launches`` (its launches on phase 23's
frames and steps); each kernel from the first phase that launched it on
its main path: the flagship's inference path for ``rows_affine`` (with
masks, which the x3 kernels' row order needs), ``gather_gemm_conv_x3``,
``masked_nn`` and ``merge_take`` (ms per frame), its train step for
``rows_queries`` and ``conv_dw_x3`` (ms per step), the exact
``gather_gemm_conv`` timed on phase 4's calls with the launches of the
frame on ``highest``, phase 6's inference for ``gather_gemm_conv_bf16``
and train step for ``conv_dw_bf16``, phase 7's inference for
``match_conv_x3``, its frame on ``highest`` for the exact ``match_conv``
(timed on the x3 kernel's calls), phase 8's one-hot bf16 frame for
``match_conv_bf16`` (its model path: 25 calls), phase 7's train step
for the exact ``conv_dw``, and phase 13's one-hot step for
``match_conv_bf16 d_feats`` (its 24 backward calls over the dual plans;
``launches``: the counted step's backward's). The bf16 and x3 kernels'
bound takes the card's dense bf16 tensor rate (``TENSOR_PASSES``: three
products for x3, two for the one-hot bf16 kernel); their entries also
carry ``useful_share``, the packed ones ``fp32_ratio``, the x3 ones
``ffma_ratio``, the exact ``conv_dw``, ``gather_gemm_conv`` and
``match_conv`` ``useful_share`` and ``sgemm_ms``,
``masked_nn`` ``unfused_bound_ms`` (its operations at the fp32 rate
without fused multiply-adds, which its contract forbids: half the data
sheet's), the rows kernels' ``searchsorted_ratio`` (back to back), ``device_ms`` and
``device_ratio`` (the device's time alone) and ``design_bound_ms``. The
last line is
``{"ok": true, "device": {...}}``.

Rehearse phases 4-7 on the CPU with the tiny flagship of
``tests/test_torch_train_step.py``: ``flagship_phases`` takes the model
and the specs (widths emptied); patch ``torch.cuda``'s events and
synchronisation, ``profile_forward`` and ``dense_engines``, and count a
launch where each wrapper of ``wrapper_sites()`` runs outside
``plain_kernels()``.
"""
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = 1e-4                      # of the largest |reference| value
# after the head's decoder: times the plain path's own spread under
# reordered sums
FLOOR_MARGIN = 10
# share of a bf16 kernel's elements bit-equal to its plain version: the two
# differ by fp32 sum order alone, which flips a bf16 rounding rarely; a
# dropped weight pass (W_hi alone) flips a fifth to a half of them
BF16_EQUAL = 0.999
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, fp32 FLOP/s outside the tensor
# cores (the exact kernels run fp32 FFMA), both at the 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# the same data sheet: dense bf16 on the tensor cores (the packed engine's
# operands, and the x3 route's three products), 700 W
PEAK_BF16 = 989e12
NN_OPS_PER_PAIR = 8             # 3 mul + 2 add (dot), 1 mul + 2 add (dist)
# PEAK_FP32 counts an FMA as two operations; masked_nn's contract forbids
# fusing, so its multiplies and adds issue at half that rate
PEAK_FP32_UNFUSED = PEAK_FP32 / 2

TL = dict(
    config=ROOT / 'configs' / 'transfusion_nusc_voxel_L.py',
    n_points=250000, max_voxels=160000,
    # encoder strided-output capacities measured for this encoder on the
    # flagship's full-scale scene (spconv1..3, conv_out)
    enc_caps=[174336, 74240, 25088, 22784],
    launches={'rows_affine': 8, 'gather_gemm_conv_x3': 21},
    widths={(5, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
            (64, 128), (128, 128)})
# the JAX package's _flagship_model('full') (__graft_entry__.py:40-151)
FLAGSHIP = dict(
    config=ROOT / 'configs' / 'MSMDFusion_nusc_voxel_LC.py',
    max_voxels=160000,
    enc_caps=[174336, 74240, 25088, 22784],
    gma_caps=[188416, 94208, 33280, 29696],
    union_caps=[161792, 179968, 78848, 26624],
    fg_caps=[30720, 23040, 15360, 7680],
    shape=dict(n=250000, v=6, m=20000, mr=15000, img_hw=(448, 800)),
    # encoder 8 + GMA 8 plans; encoder 21 + GMA 4 x (grouped, 2
    # aggregation, downscale) convs; 2 searches per GMA stage; the sums of
    # GMA stages 1-3
    launches={'rows_affine': 16, 'gather_gemm_conv_x3': 37, 'masked_nn': 8,
              'merge_take': 3},
    widths={(16, 16), (32, 32), (64, 64), (128, 128), (80, 80), (96, 96),
            (192, 192), (80, 96), (96, 128), (128, 192)})
# conv-BN pairs tools.misc.fuse_conv_bn folds in the flagship (the JAX
# fuse_tree's pairs of the same layout: tests/test_torch_flops_fuse.py)
FUSED_PAIRS = 49
# the flagship train step: the reference's stage-2 recipe as the JAX
# package's bench runs it (bench.py:258-285)
TRAIN = dict(
    optimizer=dict(type='AdamW', lr=1e-4, weight_decay=0.05),
    optimizer_config=dict(grad_clip=dict(max_norm=10)),
    lr_config=dict(policy='step', warmup='linear', warmup_iters=1000,
                   warmup_ratio=0.001, step=[4, 5]),
    total_steps=10000, steps_per_epoch=1000,
    frozen=('img_backbone', 'img_neck'),
    # forward as in inference plus 8 dual plans (encoder spconv1-3 and
    # conv_out, GMA downscales 1-4); backward: d_feats for every conv but
    # conv_input (whose input needs no gradient), dw for all 37
    launches={'rows_affine': 16, 'rows_queries': 8,
              'gather_gemm_conv_x3': 73, 'conv_dw_x3': 37, 'masked_nn': 8,
              'merge_take': 3},
    steps=5, twin=True, extras=True)
# phase 11: TransFusion-L's stage-1 step, the config's recipe
# (configs/transfusion_nusc_voxel_L.py: AdamW, weight decay 0.01, clip 0.1,
# the cyclic schedule over total_epochs of TL_STEPS_PER_EPOCH steps; the
# train-time voxel capacity max_voxels[0]) read from the config at the
# phase; forward as in inference plus 4 dual plans (spconv1-3, conv_out);
# backward: d_feats for every conv but conv_input, dw for all 21
TL_STEPS_PER_EPOCH = 1000
TL_TRAIN = dict(
    launches={'rows_affine': 8, 'rows_queries': 4, 'gather_gemm_conv_x3': 41,
              'conv_dw_x3': 21},
    steps=3, twin=True, extras=False)
# the exact fp32 product (the FFMA kernels): phase 4's counted frame and
# the FFMA timings of the x3 kernels' calls, the switch set around them
# only; the frame launches the fp32 path's kernels, the exact conv kernel
# in the x3 one's place
HIGHEST = dict(env={'MSMD_CONV_GEMM': 'highest'})


def highest_launches(launches):
    """The launches of a frame on ``HIGHEST`` for an fp32 path's
    ``launches``: each x3 conv kernel's on its exact (FFMA) one."""
    return {FFMA.get(k, k): v for k, v in launches.items()}
# phase 6: the JAX package's benchmarked setting (bench.py:116-120), the
# rulebook engine with bf16 operands; the same plans, rows and counts
PACKED = dict(
    env={'MSMD_CONV_DTYPE': 'bfloat16'},
    launches={'rows_affine': 16, 'gather_gemm_conv_bf16': 37,
              'masked_nn': 8, 'merge_take': 3},
    widths=FLAGSHIP['widths'],
    train=dict(launches={'rows_affine': 16, 'rows_queries': 8,
                         'gather_gemm_conv_bf16': 73, 'conv_dw_bf16': 37,
                         'masked_nn': 8, 'merge_take': 3},
               steps=3, twin=True, extras=False))
# phase 7: the one-hot engine, no rulebook: every conv searches its
# queries (on the x3 product by default); the backward builds each conv's
# rows for dw (37 rows_affine), whose product stays exact
ONEHOT = dict(
    env={'MSMD_CONV_ALGO': 'onehot'},
    launches={'match_conv_x3': 37, 'masked_nn': 8, 'merge_take': 3},
    widths=FLAGSHIP['widths'],
    train=dict(launches={'rows_affine': 37, 'match_conv_x3': 73,
                         'conv_dw': 37, 'masked_nn': 8, 'merge_take': 3},
               steps=2, twin=False, extras=False))
# phase 12: the flagship's stage-2 step as its config states it
# (configs/MSMDFusion_nusc_voxel_LC.py:105,191, JAX tools/train.py:110-114):
# the image branch and the LiDAR encoders frozen, phase 5's optimizer and
# schedule; the frozen encoder still runs its backward (its gradients
# count in grad_norm), so the launches are phase 5's
STAGE2_STEPS = 2
# phase 13: the bf16-compute train step with fp32 parameters (the JAX
# bench's MSMD_BF16 train, bench.py:258-300) on three engines. bf16 flows
# through the encoder's 21 convs and the GMA's 4 grouped convs and their
# backward; on the one-hot engine those run match_conv_bf16: 25 forward
# and 24 d_feats (conv_input's input takes no gradient), the 12 convs
# from the GMA union on match_conv_x3 (12 + 12)
BF16_TRAIN = (
    ('packed', PACKED['env'], PACKED['train']['launches']),
    ('x3', {}, TRAIN['launches']),
    ('one-hot', ONEHOT['env'],
     {'rows_affine': 37, 'match_conv_bf16': 49, 'match_conv_x3': 24,
      'conv_dw': 37, 'masked_nn': 8, 'merge_take': 3}))
BF16_TRAIN_STEPS = 2
# phase 14: TransFusion-LC (configs/transfusion_nusc_voxel_LC.py) on phase
# 3's LiDAR frame (the same seed's points) with six 448 x 800 cameras in
# the reference's view order (synth_scene.lc_batch) and TransFusion-L's
# encoder capacities: phase 3's launches and widths. Phase 15 trains it
# under freeze_img with its config's recipe (phase 11's launches)
LC = dict(config=ROOT / 'configs' / 'transfusion_nusc_voxel_LC.py',
          dataset='nuScenes', img_hw=(448, 800), launches=TL['launches'],
          widths=TL['widths'])
LC_TRAIN_STEPS = 2          # timed, after the counted step
# phase 16: Waymo (configs/transfusion_waymo_voxel_{L,LC}.py): the configs'
# 180,000 points (max_points_per_sample) over [-75.2, 75.2] x [-2, 4], five
# 448 x 800 cameras (neither config nor the JAX package names an image
# scale: the flagship's), the configs' 150,000-voxel capacity and the
# encoder's strided-output capacities (spconv1-3, conv_out) measured on
# this scene as TL's were, rounded up to 256 rows (``probe_caps``). Its
# step keeps phase 11's per-call checks and launches but not its twin:
# phase 11 holds the same code's twin on nuScenes, and on this 188 x 188
# BEV one head gradient (the decoder's key position embedding, a sum over
# its 35,344 cells) reads 10.11 times the reversed-order spread in every
# run (``waymo_twin_orders.py``: 5 runs over 2 calls, the same bits each),
# while six other orders of the same sums spread 1.15-3.34 times as far as
# the reversed one, the kernel path lying 3.0-8.8 times each: one order's
# spread is too noisy a yardstick there
WAYMO = dict(config=ROOT / 'configs' / 'transfusion_waymo_voxel_L.py',
             config_lc=ROOT / 'configs' / 'transfusion_waymo_voxel_LC.py',
             dataset='Waymo', n_points=180000, img_hw=(448, 800),
             enc_caps=[123904, 48640, 11264, 7680],
             launches=TL['launches'], widths=TL['widths'],
             train=dict(TL_TRAIN, steps=1, twin=False, extras=False))
ENC_SITES = ('spconv1', 'spconv2', 'spconv3', 'spconv_down2')
KERNEL_INFO = {
    'rows_affine': dict(
        route='cuda', source='msmdfusion_torch/csrc/rows_affine.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:1759'),
    'rows_queries': dict(
        route='cuda', source='msmdfusion_torch/csrc/rows_affine.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:1696'),
    'gather_gemm_conv': dict(
        route='cuda', source='msmdfusion_torch/csrc/gather_gemm_conv.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'conv_dw': dict(
        route='cuda', source='msmdfusion_torch/csrc/conv_dw.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'gather_gemm_conv_bf16': dict(
        route='cuda', source='msmdfusion_torch/csrc/gather_gemm_conv_bf16.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'conv_dw_bf16': dict(
        route='cuda', source='msmdfusion_torch/csrc/conv_dw_bf16.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'gather_gemm_conv_x3': dict(
        route='cuda', source='msmdfusion_torch/csrc/gather_gemm_conv_x3.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'conv_dw_x3': dict(
        route='cuda', source='msmdfusion_torch/csrc/conv_dw_x3.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:924'),
    'match_conv': dict(
        route='cuda', source='msmdfusion_torch/csrc/match_conv.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:615'),
    'match_conv_x3': dict(
        route='cuda', source='msmdfusion_torch/csrc/match_conv.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:615'),
    'match_conv_bf16': dict(
        route='cuda', source='msmdfusion_torch/csrc/match_conv.cu',
        replaces='msmdfusion_tpu/ops/sparse/matchconv.py:615'),
    'masked_nn': dict(
        route='cuda', source='msmdfusion_torch/csrc/masked_nn.cu',
        replaces='msmdfusion_tpu/ops/nn_argmin.py:25'),
    'merge_take': dict(
        route='cuda', source='msmdfusion_torch/csrc/merge_take.cu',
        replaces='msmdfusion_tpu/ops/sparse/merge_take.py:64'),
}
# entries of the kernels line that are one direction of a kernel's calls:
# match_conv_bf16's input gradient over the dual plans (phase 13)
DIRECTIONS = {'match_conv_bf16 d_feats': 'match_conv_bf16'}
# the wrapper that launches each kernel where it is not the kernel's name:
# the conv and dw wrappers pick their bf16 tensor-core kernels by the
# switches (and the one-hot conv by its features' dtype)
WRAPPER = {'gather_gemm_conv_bf16': 'gather_gemm_conv',
           'conv_dw_bf16': 'conv_dw',
           'gather_gemm_conv_x3': 'gather_gemm_conv',
           'conv_dw_x3': 'conv_dw',
           'match_conv_x3': 'match_conv',
           'match_conv_bf16': 'match_conv'}
# each x3 kernel's exact (FFMA) counterpart, under MSMD_CONV_GEMM=highest
FFMA = {'gather_gemm_conv_x3': 'gather_gemm_conv', 'conv_dw_x3': 'conv_dw',
        'match_conv_x3': 'match_conv'}
# the exact conv kernels (ffma_conv.cuh's body): their records carry the
# useful share and the cuBLAS yardstick
EXACT_CONVS = ('gather_gemm_conv', 'match_conv')
# bf16 tensor-core products a kernel's FLOP take: the packed kernels one,
# the bf16-feature one-hot kernel two (hi and lo of the weights), the x3
# kernels three; the others run fp32 FFMA
TENSOR_PASSES = {'gather_gemm_conv_bf16': 1, 'conv_dw_bf16': 1,
                 'match_conv_bf16': 2, 'gather_gemm_conv_x3': 3,
                 'conv_dw_x3': 3, 'match_conv_x3': 3}


def as_recorded(launches):
    """{wrapper: calls} that kernel launches {kernel: n} come from."""
    out = {}
    for name, n in launches.items():
        out[WRAPPER.get(name, name)] = out.get(WRAPPER.get(name, name), 0) + n
    return out


def kernel_of(wrapper):
    """The kernel a conv or dw wrapper launches under the switches (the
    one-hot conv on fp32 features)."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    if wrapper == 'match_conv':
        return mc.match_kernel()
    if wrapper in ('gather_gemm_conv', 'conv_dw') and mc.packed():
        return wrapper + '_bf16'
    if wrapper in ('gather_gemm_conv', 'conv_dw') and mc.x3():
        return wrapper + '_x3'
    return wrapper


def x3_route():
    """The fp32 convs run on an x3 kernel: the rulebook engine's or the
    one-hot one's."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    return mc.x3() or (mc.conv_algo() == 'onehot'
                       and mc.match_kernel() == 'match_conv_x3')


def ops_ms(name, hits, cin, cout):
    """The least time of conv or dw kernel ``name``'s products: 2 x hits
    x Cin x Cout FLOP at the fp32 rate (FFMA), or that times its
    ``TENSOR_PASSES`` at the dense bf16 tensor rate."""
    flop = 2.0 * hits * cin * cout
    if name in TENSOR_PASSES:
        return TENSOR_PASSES[name] * flop / PEAK_BF16 * 1e3
    return flop / PEAK_FP32 * 1e3


@contextlib.contextmanager
def switches(env):
    """The conv engine's switches (``MSMD_CONV_*``) set inside the scope."""
    import os
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase_laps():
    """lap(label): print the seconds since the last lap (or the call),
    by the host clock, as phase ``label``'s."""
    last = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        print(f'phase {label}: {now - last[0]:.1f} s', flush=True)
        last[0] = now
    return lap


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls,
    after one warm-up call, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wrapper_sites():
    """{kernel: (module, attribute)}: where the path looks each kernel's
    wrapper up, so that a Recorder can stand in for it."""
    from msmdfusion_torch.models.middle_encoders import gma_encoder
    from msmdfusion_torch.ops.sparse import matchconv, tensor
    return {'rows_affine': (matchconv, 'rows_affine'),
            'rows_queries': (matchconv, 'rows_queries'),
            'gather_gemm_conv': (matchconv, 'gather_gemm_conv'),
            'conv_dw': (matchconv, 'conv_dw'),
            'match_conv': (matchconv, 'match_conv'),
            'masked_nn': (gma_encoder, 'masked_nn'),
            'merge_take': (tensor, 'merge_take_rows')}


class Recorder:
    """Keep the arguments of every kernel-wrapper call made inside the
    scope (the wrappers themselves still run). ``phase`` labels the calls
    recorded while it is set (e.g. 'backward'): ``calls_in(name, phase)``."""

    def __init__(self):
        self.sites = wrapper_sites()
        self.calls = {name: [] for name in self.sites}
        self.phase = 'forward'
        self.phases = {name: [] for name in self.sites}

    def calls_in(self, name, phase):
        return [c for c, p in zip(self.calls[name], self.phases[name])
                if p == phase]

    def __enter__(self):
        self._orig = {}
        for name, (module, attr) in self.sites.items():
            orig = getattr(module, attr)
            self._orig[name] = orig

            def wrapper(*args, _name=name, _orig=orig, **kwargs):
                self.calls[_name].append((args, kwargs))
                self.phases[_name].append(self.phase)
                return _orig(*args, **kwargs)
            setattr(module, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for name, (module, attr) in self.sites.items():
            setattr(module, attr, self._orig[name])
        return False


def build_model(device, config=TL['config'], n_caps=TL['enc_caps'],
                max_voxels=None, overrides=None):
    """TransFusion-L at full width (``overrides``: dotted config keys)."""
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.models.builder import build_detector
    import msmdfusion_torch.models  # noqa: F401  (registers the modules)
    cfg = load_config(str(config), overrides)
    model_cfg = cfg.model
    if max_voxels is not None:
        model_cfg.pts_voxel_layer.max_voxels = (max_voxels, max_voxels)
    model_cfg.pts_middle_encoder.stage_capacities = list(n_caps)
    return build_detector(model_cfg, device=device, seed=SEED)


def build_flagship(device, overrides=None, caps=FLAGSHIP,
                   compute_dtype='float32'):
    """MSMDFusion at the capacities of ``_flagship_model('full')``, with
    the detector's ``compute_dtype`` (the JAX package's ``MSMD_BF16``)."""
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.models.builder import build_detector
    import msmdfusion_torch.models  # noqa: F401
    cfg = load_config(str(FLAGSHIP['config']), overrides).model
    cfg.compute_dtype = compute_dtype
    cfg.pts_voxel_layer.max_voxels = (caps['max_voxels'],) * 2
    cfg.pts_middle_encoder.stage_capacities = list(caps['enc_caps'])
    cfg.multimodal_middle_encoder.stage_capacities = list(caps['gma_caps'])
    cfg.multimodal_middle_encoder.union_capacities = list(caps['union_caps'])
    cfg.fg_max_voxels = list(caps['fg_caps'])
    return build_detector(cfg, device=device, seed=SEED)


def make_points(model, n_points, device):
    """TransFusion-L inputs (points [1, N, 5], mask [1, N]) and the
    frame's ground truth (gt_bboxes [1, 32, 9], gt_labels, gt_valid)."""
    import numpy as np
    import torch
    from msmdfusion_torch.utils.synth_scene import lidar_scene, scene_gt
    pcr = model.pts_voxel_layer['point_cloud_range']
    pts, objects = lidar_scene(np.random.RandomState(SEED), n_points, pcr)
    points = torch.from_numpy(pts)[None].to(device)
    mask = torch.ones(points.shape[:2], dtype=torch.bool, device=device)
    gt = tuple(torch.from_numpy(x)[None].to(device)
               for x in scene_gt(objects))
    return (points, mask), gt


def make_scene(model, shape, device):
    """Flagship inputs (points, mask, img, fg) of ``realistic_batch`` and
    the scene's ground truth (gt_bboxes, gt_labels, gt_valid)."""
    import torch
    from msmdfusion_torch.utils.synth_scene import realistic_batch
    batch = realistic_batch(
        dict(shape, pcr=model.pts_voxel_layer['point_cloud_range']), b=1,
        seed=SEED, return_gt=True)

    def dev(x):
        return torch.from_numpy(x).to(device)
    gt = batch['gt']
    return ((dev(batch['points']), dev(batch['points_mask']),
             dev(batch['img']), {k: dev(v) for k, v in batch['fg'].items()}),
            (dev(gt['gt_bboxes']), dev(gt['gt_labels']), dev(gt['gt_valid'])))


def make_lc_scene(config, dataset, n_points, img_hw, device):
    """TransFusion-LC inputs (points [1, N, 5], mask, img [1, V, H, W, 3],
    metas dict(lidar2img [1, V, 4, 4])) of ``synth_scene.lc_batch`` over
    ``config``'s range with the dataset's rig, and the frame's ground truth
    (boxes 9 wide with a velocity, else 7; labels below the head's
    classes)."""
    import torch
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.utils.synth_scene import LC_YAWS, lc_batch
    cfg = load_config(str(config)).model
    head = cfg.pts_bbox_head
    batch = lc_batch(
        dict(n=n_points, img_hw=img_hw, yaws=LC_YAWS[dataset],
             pcr=cfg.pts_voxel_layer.point_cloud_range), seed=SEED,
        return_gt=True, num_classes=head.num_classes,
        box_dim=9 if head.bbox_coder.code_size == 10 else 7)

    def dev(x):
        return torch.from_numpy(x).to(device)
    gt = batch['gt']
    return ((dev(batch['points']), dev(batch['points_mask']),
             dev(batch['img']),
             {k: dev(v) for k, v in batch['metas'].items()}),
            (dev(gt['gt_bboxes']), dev(gt['gt_labels']), dev(gt['gt_valid'])))


def forward(model, inputs):
    preds = model(*inputs)
    return preds, model.get_bboxes(preds)


def rel_err(got, want):
    """(max |got - want|, that over max |want|)."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def rows_checked(name, i, got, want, masked):
    """The rows kernel's output (rows, and their tap-hit masks where the
    call asked for them: the packed engine's plans) against the plain
    rows and their ``row_masks``; returns (rows, the masks' bytes)."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    got, masks = got if masked else (got, None)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f'{name} call {i}: {int((got != want).sum())} rows differ from '
          'the plain version')
    if masked:
        check(torch.equal(masks, mc.row_masks(want)),
              f'{name} call {i}: tap-hit masks differ from the rows\' ones')
    return got, 0 if masks is None else masks.numel() * 8


def device_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls queued
    behind a spin of the card (``torch.cuda._sleep``), after one warm-up
    call: the CUDA events then time the device's work alone, not the
    host's launches (a rows call spends ~40 us of host time in its Python
    wrapper, more than a small call's kernel). The spin is lengthened until
    the host has queued every call before it ends, at most 6 times (to
    2^33 cycles); ``fn`` must not synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 21
    for _ in range(7):
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < spin.elapsed_time(start):
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError('device_ms: the host never queued its calls within '
                       'the spin; does fn synchronise?')


ROWS_SOURCE = ROOT / 'msmdfusion_torch' / 'csrc' / 'rows_affine.cu'
INT_MIN = -2 ** 31


def rows_design():
    """The rows kernels' design constants, read from
    ``csrc/rows_affine.cu``: (keys of a block's window buffer, input keys
    sampled per tile row, the function giving a block's output rows for Ta
    taps)."""
    text = ROWS_SOURCE.read_text()

    def constant(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', text)[1])
    a, ra, b, rb, rc = (int(v) for v in re.search(
        r'return ta <= (\d+) \? (\d+) : ta <= (\d+) \? (\d+) : (\d+);',
        text).groups())
    return (constant('kWinCap'), constant('kSamplesPerRow'),
            lambda ta: ra if ta <= a else rb if ta <= b else rc)


def plan_queries(plan):
    """(queries [K, Ta] int64, live [K, Ta] bool) of a plan: what the rows
    kernels search, and where (``inb``, a real query within int32)."""
    import torch
    from msmdfusion_torch.ops.sparse.tensor import INT_MAX
    if plan.queries is not None:
        q = plan.queries.to(torch.int64)
        return q, plan.inb & (plan.queries != INT_MAX)
    q = plan.okeys.to(torch.int64)[:, None] + \
        plan.dkey.to(torch.int64)[None, :]
    live = plan.inb & (plan.okeys != INT_MAX)[:, None] & \
        (q <= INT_MAX) & (q >= INT_MIN)
    return q, live


def rows_windows(in_keys, plan) -> dict:
    """The rows kernels' key windows of a plan, stated in PyTorch for
    measurement (the kernels do not read it): per tile of output rows,
    each tap's range of queries (explicit plans: the least and greatest
    live query; affine plans: the tile's least and greatest valid okey
    plus the tap's dkey, a superset, clamped to int32), the taps grouped (a
    tap whose range overlaps the previous tap's with a range joins its
    group), each group's window ``[lo, hi)`` = [lower bound of its least
    query, upper bound of its greatest) of ``in_keys``, and the stride of
    the tile's index of its windows in the block's buffer: 1 (every key,
    from starts rounded down to 4 keys) where the windows fit together,
    else the least s >= 2 for which every s-th key of each fits.

    Returns ``group`` [T, Ta] (-1: no range), ``lo``, ``hi`` [T, Ta]
    (group g valid for ``g < groups``), ``groups`` [T], ``stride`` [T],
    ``staged`` [T]: the keys each tile copies into its buffer, and
    ``staged_keys`` their sum.
    """
    import torch
    from msmdfusion_torch.ops.sparse.tensor import INT_MAX
    cap, _, tile_rows = rows_design()
    k, ta = plan.inb.shape
    tile = tile_rows(ta)
    tiles = -(-k // tile)
    pad = tiles * tile - k

    def per_tile(x, fill):
        x = torch.nn.functional.pad(x.cpu().to(torch.int64),
                                    (0, 0) * (x.dim() - 1) + (0, pad),
                                    value=fill)
        return x.view(tiles, tile, *x.shape[1:])
    if plan.queries is not None:
        q = per_tile(plan.queries, INT_MAX)
        live = per_tile(plan.inb, 0).bool() & (q != INT_MAX)
        tmin = torch.where(live, q, INT_MAX).amin(1)
        tmax = torch.where(live, q, INT_MIN).amax(1)
    else:
        okeys = per_tile(plan.okeys, INT_MAX)
        valid = okeys != INT_MAX
        dkey = plan.dkey.cpu().to(torch.int64)[None]
        lo = torch.where(valid, okeys, INT_MAX).amin(1)[:, None] + dkey
        hi = torch.where(valid, okeys, INT_MIN).amax(1)[:, None] + dkey
        any_ = valid.any(1)[:, None] & (lo <= INT_MAX) & (hi >= INT_MIN)
        tmin = torch.where(any_, lo.clamp(min=INT_MIN), INT_MAX)
        tmax = torch.where(any_, hi.clamp(max=INT_MAX), INT_MIN)
    alive = tmin <= tmax
    group = torch.full((tiles, ta), -1, dtype=torch.int64)
    groups = torch.zeros(tiles, dtype=torch.int64)
    prev_lo = torch.zeros(tiles, dtype=torch.int64)
    prev_hi = torch.zeros(tiles, dtype=torch.int64)
    seen = torch.zeros(tiles, dtype=torch.bool)
    for t in range(ta):
        ok = alive[:, t]
        joins = ok & seen & (tmin[:, t] <= prev_hi) & (tmax[:, t] >= prev_lo)
        groups = groups + (ok & ~joins).to(torch.int64)
        group[:, t] = torch.where(ok, groups - 1, -1)
        prev_lo = torch.where(ok, tmin[:, t], prev_lo)
        prev_hi = torch.where(ok, tmax[:, t], prev_hi)
        seen = seen | ok
    slot = group.clamp(min=0)
    gmin = torch.full((tiles, ta), INT_MAX, dtype=torch.int64).scatter_reduce(
        1, slot, torch.where(alive, tmin, INT_MAX), 'amin')
    gmax = torch.full((tiles, ta), INT_MIN, dtype=torch.int64).scatter_reduce(
        1, slot, torch.where(alive, tmax, INT_MIN), 'amax')
    keys = in_keys.to(torch.int64).cpu()
    valid = torch.arange(ta)[None, :] < groups[:, None]
    lo = torch.where(valid, torch.searchsorted(keys, gmin), 0)
    hi = torch.where(valid, torch.searchsorted(keys, gmax, right=True), 0)
    full = hi > lo
    exact = torch.where(full, (hi - (lo & ~3) + 3) // 4 * 4, 0).sum(1)
    span = torch.where(full, hi - lo, 0).sum(1)
    room = (cap - groups).clamp(min=1)
    stride = torch.where(exact <= cap, 1,
                         ((span + room - 1) // room).clamp(min=2))
    sampled = torch.where(full, (hi - lo + stride[:, None] - 1)
                          // stride[:, None], 0).sum(1)
    staged = torch.where(stride == 1, exact, sampled)
    return dict(group=group, lo=lo, hi=hi, groups=groups, stride=stride,
                staged=staged, staged_keys=int(staged.sum()))


def rows_calls(name, calls, reps, card):
    """Kernel ``name`` (rows_affine or rows_queries) vs its plain version
    and torch.searchsorted on the same queries, per call: rows (and masks)
    equal; the times over back-to-back calls (``cuda_ms``) of the kernel
    with its wrapper, the plain version and searchsorted, as every other
    kernel is timed, and apart the device's time alone (``device_ms``) of
    the kernel and searchsorted; the bound on the function's own bytes
    and, apart, on the bytes the kernel's design reads (``rows_windows``:
    the samples and staged windows for in_keys, and a 32-byte sector per
    live query of a sampled tile); the largest window and the share of
    windows in tiles whose windows overflow the block's buffer (sampled
    index)."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    from msmdfusion_torch.ops.sparse.tensor import INT_MAX
    affine = name == 'rows_affine'
    wrapper = mc.rows_affine if affine else mc.rows_queries
    plain = mc.rows_affine_plain if affine else mc.rows_queries_plain
    _, samples_per_row, tile_rows = rows_design()
    out = []
    for i, (args, kwargs) in enumerate(calls):
        in_keys, inb = args[0], args[-1]
        plan = (mc.MatchPlan(inb=inb, okeys=args[1], dkey=args[2]) if affine
                else mc.MatchPlan(inb=inb, queries=args[1]))
        masked = bool(kwargs.get('masks'))
        got, mask_bytes = rows_checked(name, i, wrapper(*args, **kwargs),
                                       plain(*args), masked)
        q, live = plan_queries(plan)
        q32 = q.clamp(INT_MIN, INT_MAX).to(torch.int32)
        k, ta = inb.shape
        # the function's bytes: in_keys, inb and okeys + dkey or the
        # queries read once, the rows and masks written once
        tile_bytes = inb.numel() + (k * 4 + ta * 4 if affine
                                    else q.numel() * 4)
        own = in_keys.numel() * 4 + tile_bytes + got.numel() * 4 + \
            mask_bytes
        w = rows_windows(in_keys, plan)
        full = (torch.arange(ta)[None] < w['groups'][:, None]) & \
            (w['hi'] > w['lo'])
        over = w['stride'] > 1
        tiles = torch.arange(k) // tile_rows(ta)
        sampled_queries = int(live[over[tiles].to(live.device)].sum())
        design = (own - in_keys.numel() * 4 + sampled_queries * 32
                  + (w['staged_keys'] + w['groups'].numel() * tile_rows(ta)
                     * samples_per_row) * 4)
        call = lambda: wrapper(*args, **kwargs)            # noqa: E731
        search = lambda: torch.searchsorted(in_keys, q32)  # noqa: E731
        rec = dict(
            k_in=in_keys.numel(), k_out=k, ta=ta,
            hits=int((got >= 0).sum()), err=0.0, masked=masked,
            ms=cuda_ms(call, reps),
            plain_ms=cuda_ms(lambda: plain_rows(plain(*args), masked),
                             reps),
            library_ms=cuda_ms(search, reps),
            device_ms=device_ms(call, reps),
            library_device_ms=device_ms(search, reps),
            bytes_ms=own / PEAK_BYTES * 1e3, ops_ms=0.0,
            design_ms=design / PEAK_BYTES * 1e3,
            largest_window=int((w['hi'] - w['lo'])[full].max())
            if full.any() else 0,
            over_cap=float((over[:, None] & full).sum())
            / max(int(full.sum()), 1))
        out.append(rec)
        print(f"{name}[{i}] K_in={rec['k_in']} K={k} Ta={ta} "
              f"hits={rec['hits']} {'with masks ' if masked else ''}exact "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"searchsorted_ms={rec['library_ms']:.4f} "
              f"searchsorted_ratio={rec['ms'] / rec['library_ms']:.3f} "
              f"device_ms={rec['device_ms']:.4f} searchsorted_device_ms="
              f"{rec['library_device_ms']:.4f} device_ratio="
              f"{rec['device_ms'] / rec['library_device_ms']:.3f} "
              f"bound_ms={rec['bytes_ms']:.4f} "
              f"design_bound_ms={rec['design_ms']:.4f} "
              f"largest_window={rec['largest_window']} "
              f"windows_over_cap={rec['over_cap']:.4f} [{card}]",
              flush=True)
    return out


def rows_ratios(recs):
    """A rows kernel's sums beside ``torch.searchsorted``'s over a path's
    calls: the ratio back to back, the device's times alone and their
    ratio, the bound on the design's bytes."""
    ms = sum(r['ms'] for r in recs)
    dev = sum(r['device_ms'] for r in recs)
    return dict(
        searchsorted_ratio=ms / sum(r['library_ms'] for r in recs),
        device_ms=dev,
        device_ratio=dev / sum(r['library_device_ms'] for r in recs),
        design_bound_ms=sum(r['design_ms'] for r in recs))


def rows_sums(label, recs):
    """One line of a rows kernel's sums over a path's calls."""
    r = rows_ratios(recs)
    return (f"{label}: {len(recs)} calls ms={sum(x['ms'] for x in recs):.4f}"
            f" searchsorted_ms={sum(x['library_ms'] for x in recs):.4f} "
            f"searchsorted_ratio={r['searchsorted_ratio']:.3f} device_ms="
            f"{r['device_ms']:.4f} searchsorted_device_ms="
            f"{sum(x['library_device_ms'] for x in recs):.4f} device_ratio="
            f"{r['device_ratio']:.3f} bound_ms="
            f"{sum(x['bytes_ms'] for x in recs):.4f} design_bound_ms="
            f"{r['design_bound_ms']:.4f}")


def plain_rows(rows, masked):
    """The plain rows, with their ``row_masks`` where the call asked."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    return (rows, mc.row_masks(rows)) if masked else rows


def held_to_sums(name, got, want, magnitude):
    """Each element of ``got`` within TOL of the magnitude of its own sum
    and the whole within TOL of the largest |want|; returns (max abs
    error, that over max |want|, the worst element error over its sum's
    magnitude)."""
    import torch
    check(bool(torch.isfinite(got).all()), f'{name}: non-finite output')
    diff = (got - want).abs()
    bad = int((diff > TOL * magnitude).sum())
    check(bad == 0, f'{name}: {bad} elements differ by more than {TOL} of '
          'the magnitude of their sum')
    err, rel = rel_err(got, want)
    check(rel <= TOL, f'{name}: error {err:.3g} is {rel:.3g} of max |ref|, '
          f'above {TOL}')
    return err, rel, float((diff / magnitude.clamp_min(1e-30)).max()) \
        if diff.numel() else 0.0


def plain_gemms():
    """The plain products a rulebook conv or dw call is held to on the
    route the switches pick: the x3 kernels to their x3 plain version and
    to the exact one (x3 lies ~2^-17 of each sum's magnitude from it), the
    others to their own (the exact product; bf16 operands under the packed
    switch, whatever ``gemm``)."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    return ('x3', 'exact') if mc.x3() else ('exact',)


def dw_record(name, i, args, kwargs, reps, plain_reps):
    """One conv_dw call on the kernel the switches pick, against its plain
    versions (``plain_gemms``; the first is the one the record's error and
    ``plain_ms`` are of), two calls bit-equal, timed."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    feats, rows, g = args
    k_out, ta = rows.shape
    cin, cout = feats.shape[1], g.shape[1]
    check(not mc.needs_order() or kwargs.get('order') is not None,
          f'{name} call {i}: the path gave it no row order')
    got = mc.conv_dw(*args, **kwargs)
    again = mc.conv_dw(*args, **kwargs)
    magnitude = mc.conv_dw_plain(feats.abs(), rows, g.abs())
    torch.cuda.synchronize()
    check(torch.equal(got, again), f'{name} call {i}: two calls differ')
    held = [held_to_sums(f'{name} call {i} ({cin}x{cout}) against the '
                         f'{gemm} plain version', got,
                         mc.conv_dw_plain(*args, gemm=gemm), magnitude)
            for gemm in plain_gemms()]
    gemm = plain_gemms()[0]
    hits = int((rows >= 0).sum())
    nbytes = 4 * (feats.numel() + rows.numel() + g.numel() + got.numel())
    rec = dict(
        cin=cin, cout=cout, k_in=feats.shape[0], k_out=k_out, ta=ta,
        hits=hits, err=held[0][0], rel=held[0][1], elem=held[0][2],
        elem_exact=held[-1][2],
        ms=cuda_ms(lambda: mc.conv_dw(*args, **kwargs), reps),
        plain_ms=cuda_ms(lambda: mc.conv_dw_plain(*args, gemm=gemm),
                         plain_reps),
        library_ms=None, bytes_ms=nbytes / PEAK_BYTES * 1e3,
        ops_ms=ops_ms(name, hits, cin, cout))
    if name == 'conv_dw':
        rec['staged'] = dw_multiplied(rows, cin, cout)
        products = sgemm_operands(feats, rows, g)
        rec['sgemm_ms'] = cuda_ms(
            lambda: [torch.bmm(x, y) for x, y in products], reps)
        del products
    if name == 'conv_dw_x3':
        products = [(*bf16_parts(x[0]), *bf16_parts(y[0]))
                    for x, y in sgemm_operands(feats, rows, g)]
        rec['bf16mm_ms'] = cuda_ms(lambda: bf16_x3_mms(products), reps)
        del products
    return rec


def conv_sgemm_operands(feats, rows, weights):
    """Per tap, the operands of an exact conv's product gathered
    beforehand: (feats of the tap's hit rows [n_t, Cin], weights[t]), so
    that ``torch.mm`` of each pair is the tap's share of the output rows
    it hits: the cuBLAS fp32 yardstick (``sgemm_ms``)."""
    import torch
    out = []
    for t in range(rows.shape[1]):
        r = rows[:, t]
        x = feats.index_select(0, r[r >= 0].to(torch.int64))
        out.append((x, weights[t]))
    return out


def dw_multiplied(rows, cin, cout):
    """Row-taps the exact ``conv_dw`` multiplies: its hits alone where it
    streams rows (both widths at most 32); else, per tap and 2048-row
    segment of each chunk (from the chunk's first row), the hits rounded
    up to whole 16-hit stages. The useful share is the hits over these."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    k_out, ta = rows.shape
    hit = (rows >= 0).to(torch.int64)
    if mc.dw_narrow(cin, cout):
        return int(hit.sum())
    chunk = mc.conv_dw_launch(k_out, ta, cin, cout).chunk_rows
    o = torch.arange(k_out, device=rows.device)
    per_chunk = -(-chunk // mc.DW_SEG)
    seg = o // chunk * per_chunk + o % chunk // mc.DW_SEG
    n = torch.zeros((int(seg.max()) + 1 if k_out else 0, ta),
                    dtype=torch.int64, device=rows.device)
    n.index_add_(0, seg, hit)
    return mc.DW_BK * int(((n + mc.DW_BK - 1) // mc.DW_BK).sum())


def sgemm_operands(feats, rows, g):
    """Per tap, the operands of ``conv_dw``'s product gathered beforehand:
    (feats of the tap's hits [1, Cin, n_t] as a transposed view, g of their
    rows [1, n_t, Cout]), so that ``torch.bmm`` of each pair is the tap's
    dw: the cuBLAS fp32 yardstick (``sgemm_ms``)."""
    import torch
    out = []
    for t in range(rows.shape[1]):
        o = torch.nonzero(rows[:, t] >= 0).squeeze(1)
        x = feats.index_select(0, rows[o, t].to(torch.int64))
        out.append((x.mT[None], g.index_select(0, o)[None]))
    return out


def dw_calls(calls, reps, card, plain_reps=3, fp32=None):
    """Kernel conv_dw (``conv_dw_x3`` on the fp32 engine's default route,
    ``conv_dw_bf16`` under the packed switch, the exact ``conv_dw`` under
    ``MSMD_CONV_GEMM=highest`` and on the one-hot engine) vs its plain
    versions per call (``dw_record``): each element held to TOL of the
    magnitude of its sum (the plain dw of |feats| and |g|); two calls give
    the same bits. The x3 and packed kernels must be given their plan's
    row order. Each x3 call is run again on the exact kernel, under
    ``MSMD_CONV_GEMM=highest`` set around it only, held to the exact plain
    version and timed (``rec['ffma']``, its ratio ``ffma_ratio``).
    ``fp32`` (the fp32 engine's kernel's records of the same calls, x3)
    gives each packed call's time ratio to it."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    name = kernel_of('conv_dw')
    out = []
    for i, (args, kwargs) in enumerate(calls):
        rec = dw_record(name, i, args, kwargs, reps, plain_reps)
        extra = ''
        if mc.needs_order():
            rec['staged'] = dw_staged_pairs(kwargs['order'], rec['cin'],
                                            rec['cout'])
            extra += f"useful={rec['hits'] / max(rec['staged'], 1):.3f} "
        if name == 'conv_dw_x3':
            extra += f"bf16mm_ms={rec['bf16mm_ms']:.4f} "
        if name == 'conv_dw':
            extra += exact_extra(rec)
        if mc.x3():
            with switches(HIGHEST['env']):
                rec['ffma'] = dw_record('conv_dw', i, args, {}, reps,
                                        plain_reps)
            extra += ffma_ratio(rec) + exact_extra(rec['ffma'], 'ffma_')
        extra += same_call_ratio(rec, fp32, i)
        out.append(rec)
        print(f"{name}[{i}] {rec['cin']}x{rec['cout']} K_in={rec['k_in']} "
              f"K_out={rec['k_out']} Ta={rec['ta']} hits={rec['hits']} "
              f"deterministic max_abs_err={rec['err']:.3g} ({rec['rel']:.3g}"
              f" of max |ref|) worst |err|/|sum| {rec['elem']:.3g}"
              f"{' (exact: %.3g)' % rec['elem_exact'] if mc.x3() else ''} "
              f"(limit {TOL}) ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={max(rec['bytes_ms'], rec['ops_ms']):.4f} "
              f"{extra}[{card}]", flush=True)
    return out


def exact_extra(rec, prefix=''):
    """' useful=.. sgemm_ms=.. sgemm_ratio=..' of an exact (FFMA) kernel's
    record (``conv_dw``, ``gather_gemm_conv``, ``match_conv``): the hits
    over the row-taps it multiplies, and the cuBLAS yardstick on the same
    products."""
    return (f"{prefix}useful={rec['hits'] / max(rec['staged'], 1):.3f} "
            f"{prefix}sgemm_ms={rec['sgemm_ms']:.4f} "
            f"{prefix}sgemm_ratio={rec['ms'] / rec['sgemm_ms']:.3f} ")


def block_staged_row_taps(rows):
    """Row-taps the one-hot tensor-core kernels multiply on ``rows``: 16
    rows for each tap of each 16-row slice's mask, in each 128-row block
    with its rows stably sorted by tap-hit mask, as the kernels do."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    block = mc.SLICE_ROWS * 8
    masks = mc.row_masks(rows)
    masks = torch.nn.functional.pad(masks, (0, -masks.shape[0] % block))
    masks = torch.sort(masks.view(-1, block), dim=1, stable=True).values
    m = masks.reshape(-1, mc.SLICE_ROWS)
    while m.shape[1] > 1:
        m = m[:, :m.shape[1] // 2] | m[:, m.shape[1] // 2:]
    return mc.SLICE_ROWS * sum(int(((m >> t) & 1).sum())
                               for t in range(rows.shape[1]))


def ffma_multiplied(rows):
    """Row-taps the exact conv kernels (``gather_gemm_conv``,
    ``match_conv``) multiply on ``rows``: per block of ``FFMA_ROWS`` rows,
    each tap's hits in whole ``FFMA_SLICE``-row slices. The useful share
    is the hits over these."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    hit = (rows >= 0).to(torch.int64)
    hit = torch.nn.functional.pad(hit,
                                  (0, 0, 0, -hit.shape[0] % mc.FFMA_ROWS))
    n = hit.view(-1, mc.FFMA_ROWS, rows.shape[1]).sum(1)
    return mc.FFMA_SLICE * int(((n + mc.FFMA_SLICE - 1) // mc.FFMA_SLICE)
                               .sum())


def ffma_ratio(rec):
    """' ffma_ms=.. ffma_ratio=..': an x3 call's time over the exact
    (FFMA) kernel's on the same call."""
    f = rec['ffma']
    return (f"ffma_ms={f['ms']:.4f} ffma_ratio={rec['ms'] / f['ms']:.3f} "
            f"ffma_worst_|err|/|sum| {f['elem']:.3g} ")


def conv_staged_row_taps(order, ta, rows=16):
    """Row-taps the tensor-core conv multiplies: ``rows`` rows for each tap
    of each slice's mask, 16-row slices in the packed conv (mma.sync
    tiles), 64-row tiles in the x3 one (wgmma tiles); the useful share is
    the hits over these."""
    m = order.slice_masks(rows)
    return rows * sum(int(((m >> t) & 1).sum()) for t in range(ta))


def dw_staged_pairs(order, cin, cout):
    """Pair slots the tensor-core dw kernel of the switches stages: each
    chunk of each tap's pair list in whole stages (``conv_dw_bf16``'s 32 or
    64 pairs, ``conv_dw_x3``'s ``DW_X3_PAIRS``); the useful share is the
    hits over these."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    if mc.packed():
        tile, chunk, _ = mc.conv_dw_bf16_launch(order.tap_hits, cin, cout)
        step = mc.dw_stage_pairs(tile)
    else:
        chunk, step = mc.dw_x3_chunk(order.tap_hits), mc.DW_X3_PAIRS
    return sum(n // chunk * chunk + -(-(n % chunk) // step) * step
               for n in order.tap_hits)


def same_call_ratio(rec, fp32, i):
    """' fp32_ratio=x': this call's time over the fp32 kernel's on the
    same call (``fp32``: that kernel's records, same shapes, in order)."""
    if fp32 is None:
        return ''
    f = fp32[i]
    check((f['cin'], f['cout'], f['k_out'], f['hits']) ==
          (rec['cin'], rec['cout'], rec['k_out'], rec['hits']),
          f'call {i}: the fp32 record is of another call')
    rec['fp32_ms'] = f['ms']
    return f"fp32_ms={f['ms']:.4f} fp32_ratio={rec['ms'] / f['ms']:.3f} "


def match_plan_bytes(in_keys, plan):
    """Bytes a one-hot conv reads of its plan: the keys it searches and
    the plan (inb, the queries or okeys and dkey), not rows."""
    return 4 * in_keys.numel() + plan.inb.numel() + 4 * (
        plan.queries.numel() if plan.queries is not None
        else plan.okeys.numel() + plan.dkey.numel())


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits; the smallest normal's at
    0)."""
    import torch
    e = torch.frexp(x.abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(x), e - 8)


def bf16_equal(got, want):
    """(share of ``got``'s elements bit-equal to ``want``'s, whether that
    is enough): at most 1 - BF16_EQUAL of them may differ, and one always
    (a call of a few elements)."""
    n = got.numel()
    differ = int((got != want).sum())
    return 1.0 - differ / max(n, 1), differ <= max(1, int((1 - BF16_EQUAL)
                                                         * n))


def match_bf16_calls(model, inputs, card, reps=2, plain_reps=2):
    """The bf16-feature one-hot kernel ``match_conv_bf16`` on the fp32
    one-hot frame's widths: one one-hot forward records its ``match_conv``
    calls, and those calls with their features rounded to bf16 are run:
    launches set to 0, each call once, the launches read and held. Then each
    call against the plain bf16 version (``bf16_record``). (Phase 8's
    one-hot bf16 frame is the kernel's model path.)
    Returns ({'match_conv_bf16': records}, launches)."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.ops.sparse import matchconv as mc
    with torch.no_grad(), Recorder() as rec:
        forward(model, inputs)
    calls = [((args[0].to(torch.bfloat16), *args[1:]), kwargs)
             for args, kwargs in rec.calls['match_conv']]
    del rec
    name = 'match_conv_bf16'
    with torch.no_grad():
        kernels.reset_launches()
        for args, kwargs in calls:
            mc.match_conv(*args, **kwargs)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
    print(f'{name} path (the one-hot frame\'s calls on bf16 features): '
          f'launches {launches}', flush=True)
    check_launches(f'{name} path', launches, {name: len(calls)})
    with torch.no_grad():
        out = [bf16_record(i, args, kwargs, reps, plain_reps, card)
               for i, (args, kwargs) in enumerate(calls)]
    print(f"{name} sums over the one-hot frame's {len(out)} calls: "
          f"ms={sum(r['ms'] for r in out):.3f} "
          f"plain_ms={sum(r['plain_ms'] for r in out):.3f} bound_ms="
          f"{sum(max(r['bytes_ms'], r['ops_ms']) for r in out):.3f} "
          f"[{card}]", flush=True)
    return {name: out}, launches


def conv_record(name, i, args, kwargs, order, reps, plain_reps):
    """One conv call (``gather_gemm_conv`` or ``match_conv`` on the kernel
    the switches pick) against its plain versions (``plain_gemms``; the
    first is the one the record's error and ``plain_ms`` are of), with the
    recorded epilogue and without any, timed."""
    import functools
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    if len(args) == 4:                      # match_conv: no rulebook
        feats, in_keys, plan, weights = args
        conv, plain = mc.match_conv, mc.match_conv_plain
        gemms = ('x3', 'exact') if name == 'match_conv_x3' else ('exact',)
        rows = mc.plan_rows_plain(in_keys, plan)
        plan_bytes = match_plan_bytes(in_keys, plan)
    else:
        feats, rows, weights = args
        conv, plain = mc.gather_gemm_conv, mc.gather_gemm_conv_plain
        gemms = plain_gemms()
        plan_bytes = 4 * rows.numel()
        if mc.needs_order():
            check(order is not None,
                  f'{name} call {i}: the path gave it no row order')
            conv = functools.partial(conv, order=order)
    k_out, ta = rows.shape
    cin, cout = weights.shape[1], weights.shape[2]
    magnitude = mc.gather_gemm_conv_plain(feats.abs(), rows, weights.abs())
    errs, rels, elems = [], [], []
    for kw in ((kwargs, {}) if kwargs else ({},)):
        got = conv(*args, **kw)
        mag = magnitude
        if kw.get('scale') is not None:
            mag = mag * kw['scale'].abs()
        if kw.get('shift') is not None:
            mag = mag + kw['shift'].abs()
        for gemm in gemms:
            want = plain(*args, **kw, gemm=gemm)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f'{name} call {i}: non-finite output')
            diff = (got - want).abs()
            what = (f'{name} call {i} ({cin}->{cout}, epilogue={bool(kw)}'
                    f', against the {gemm} plain version)')
            bad = int((diff > TOL * mag).sum())
            check(bad == 0, f'{what}: {bad} elements differ by more than '
                  f'{TOL} of the magnitude of their sum')
            err, rel = rel_err(got, want)
            check(rel <= TOL, f'{what}: error {err:.3g} is {rel:.3g} of '
                  f'max |ref|, above {TOL}')
            errs.append((gemm, err))
            rels.append((gemm, rel))
            elems.append((gemm, float((diff / mag.clamp_min(1e-30)).max())))
    # scale of the conv's sums on the active rows (``want`` is the call
    # without epilogue)
    active = want[(rows >= 0).any(1)].abs()
    median = float(active.median()) if active.numel() else 0.0
    hits = int((rows >= 0).sum())
    n_epi = sum(kwargs.get(k) is not None for k in ('scale', 'shift'))
    nbytes = 4 * (feats.numel() + weights.numel() + n_epi * cout
                  + k_out * cout) + plan_bytes
    if kwargs.get('out_valid') is not None:
        nbytes += k_out

    def worst(pairs, gemm):
        return max(v for g, v in pairs if g == gemm)
    plain_kw = dict(kwargs, gemm=gemms[0])
    rec = dict(
        cin=cin, cout=cout, k_in=feats.shape[0], k_out=k_out, ta=ta,
        hits=hits, err=worst(errs, gemms[0]), rel=worst(rels, gemms[0]),
        elem=worst(elems, gemms[0]), elem_exact=worst(elems, gemms[-1]),
        median=median, max_ref=float(active.max()) if active.numel()
        else 0.0,
        ms=cuda_ms(lambda: conv(*args, **kwargs), reps),
        plain_ms=cuda_ms(lambda: plain(*args, **plain_kw), plain_reps),
        library_ms=None,
        bytes_ms=nbytes / PEAK_BYTES * 1e3,
        ops_ms=ops_ms(name, hits, cin, cout))
    if name in EXACT_CONVS:
        rec['staged'] = ffma_multiplied(rows)
        products = conv_sgemm_operands(feats, rows, weights)
        rec['sgemm_ms'] = cuda_ms(
            lambda: [torch.mm(x, w) for x, w in products], reps)
        del products
    if name == 'gather_gemm_conv_x3':
        products = [(*bf16_parts(x), *bf16_parts(w))
                    for x, w in conv_sgemm_operands(feats, rows, weights)]
        rec['bf16mm_ms'] = cuda_ms(lambda: bf16_x3_mms(products), reps)
        del products
    return rec


def bf16_parts(x):
    """The x3 split of fp32 ``x`` as two bf16 tensors (hi, lo)."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    return tuple(p.to(torch.bfloat16) for p in mc.split_hi_lo(x))


def bf16_x3_mms(products):
    """The x3 kernels' cuBLAS yardstick (``bf16mm_ms``): per tap, the three
    bf16 ``torch.mm`` hi.hi, hi.lo and lo.hi of operands gathered and split
    beforehand (bf16 out; the sums not taken)."""
    import torch
    return [(torch.mm(xh, wh), torch.mm(xh, wl), torch.mm(xl, wh))
            for xh, xl, wh, wl in products]


def conv_calls(calls, widths, reps, card, plain_reps=3, label=None,
               fp32=None):
    """Each recorded conv call (``gather_gemm_conv``, which launches
    ``gather_gemm_conv_x3`` on the fp32 engine's default route,
    ``gather_gemm_conv_bf16`` under the packed switch and the exact
    ``gather_gemm_conv`` under ``MSMD_CONV_GEMM=highest``, or
    ``match_conv``) against its plain versions (``conv_record``), with the
    recorded epilogue and without any. Each element is held to TOL of the
    magnitude of its own sum (the plain conv of |feats| and |weights|,
    through the epilogue's |scale| and |shift|), whatever its row's scale,
    and the whole output to TOL of its largest |value|; the x3 kernel so
    against its x3 plain version and the exact one; every width in
    ``widths`` must occur. The x3 and packed kernels must be given their
    plan's row order (it is not an epilogue argument). Each x3 call is run
    again on the exact kernel, under ``MSMD_CONV_GEMM=highest`` set around
    it only, held to the exact plain version and timed (``rec['ffma']``,
    its ratio ``ffma_ratio``). ``fp32`` (the fp32 engine's kernel's
    records of the same calls, x3) gives each packed call's time ratio to
    it."""
    from msmdfusion_torch.ops.sparse import matchconv as mc
    out = []
    for i, (args, kwargs) in enumerate(calls):
        kwargs = dict(kwargs)
        order = kwargs.pop('order', None)
        name = kernel_of('match_conv' if len(args) == 4 else
                         'gather_gemm_conv')
        label = label or name
        rec = conv_record(name, i, args, kwargs, order, reps, plain_reps)
        extra = ''
        if order is not None:
            tile = 64 if name == 'gather_gemm_conv_x3' else 16
            rec['staged'] = conv_staged_row_taps(order, rec['ta'], tile)
            extra += f"useful={rec['hits'] / max(rec['staged'], 1):.3f} "
            if tile == 64:
                rec['staged16'] = conv_staged_row_taps(order, rec['ta'])
                extra += (f"useful16="
                          f"{rec['hits'] / max(rec['staged16'], 1):.3f} "
                          f"bf16mm_ms={rec['bf16mm_ms']:.4f} ")
        if name == 'match_conv_x3':
            rec['staged'] = block_staged_row_taps(
                mc.plan_rows_plain(args[1], args[2]))
            extra += f"useful={rec['hits'] / max(rec['staged'], 1):.3f} "
        if name in EXACT_CONVS:
            extra += exact_extra(rec)
        if name in FFMA:
            with switches(HIGHEST['env']):
                rec['ffma'] = conv_record(FFMA[name], i, args, kwargs, None,
                                          reps, plain_reps)
            extra += ffma_ratio(rec) + exact_extra(rec['ffma'], 'ffma_')
        extra += same_call_ratio(rec, fp32, i)
        out.append(rec)
        print(f"{label}[{i}] {rec['cin']}->{rec['cout']} K_in={rec['k_in']} "
              f"K_out={rec['k_out']} Ta={rec['ta']} hits={rec['hits']} "
              f"epilogue={sorted(k for k, v in kwargs.items() if v is not None and v is not False)} "
              f"max_abs_err={rec['err']:.3g} ({rec['rel']:.3g} of max "
              f"|ref|; |ref| max {rec['max_ref']:.3g} median "
              f"{rec['median']:.3g}) worst |err|/|sum| {rec['elem']:.3g}"
              f"{' (exact: %.3g)' % rec['elem_exact'] if name in FFMA else ''}"
              f" (limit {TOL}) ms={rec['ms']:.4f} "
              f"plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={max(rec['bytes_ms'], rec['ops_ms']):.4f} "
              f"{extra}[{card}]", flush=True)
    covered = {(r['cin'], r['cout']) for r in out}
    check(widths <= covered,
          f'widths not exercised: {sorted(widths - covered)}')
    return out


def nn_calls(calls, reps, card, plain_reps=3):
    """Kernel masked_nn vs its plain version per call: idx and d2 equal."""
    import torch
    from msmdfusion_torch.ops import nn_argmin
    out = []
    for i, (args, kwargs) in enumerate(calls):
        a, ab, b, bb, b_valid = args
        idx, d2 = nn_argmin.masked_nn(*args, **kwargs)
        p_idx, p_d2 = nn_argmin.masked_nn_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(idx, p_idx) and torch.equal(d2, p_d2),
              f'masked_nn call {i}: {int((idx != p_idx).sum())} indices and '
              f'{int((d2 != p_d2).sum())} distances differ from the plain '
              'version')
        # the pairs this run's data needs: each A row against the valid B
        # rows of its batch
        pairs = sum(int((ab == g).sum()) * int((b_valid & (bb == g)).sum())
                    for g in torch.unique(bb[b_valid]).tolist())
        # a, ab and b, bb, b_valid read once; idx and d2 written once
        nbytes = 16 * a.shape[0] + 17 * b.shape[0] + 8 * a.shape[0]
        rec = dict(
            na=a.shape[0], nb=b.shape[0], pairs=pairs,
            found=int((idx >= 0).sum()), err=0.0,
            ms=cuda_ms(lambda: nn_argmin.masked_nn(*args), reps),
            plain_ms=cuda_ms(lambda: nn_argmin.masked_nn_plain(*args),
                             plain_reps),
            library_ms=None, bytes_ms=nbytes / PEAK_BYTES * 1e3,
            ops_ms=NN_OPS_PER_PAIR * pairs / PEAK_FP32 * 1e3,
            unfused_ms=NN_OPS_PER_PAIR * pairs / PEAK_FP32_UNFUSED * 1e3)
        out.append(rec)
        print(f"masked_nn[{i}] Na={rec['na']} Nb={rec['nb']} "
              f"pairs={pairs} found={rec['found']} exact "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={max(rec['bytes_ms'], rec['ops_ms']):.4f} "
              f"unfused_bound_ms={max(rec['bytes_ms'], rec['unfused_ms']):.4f}"
              f" [{card}]", flush=True)
    return out


def take_calls(calls, reps, card):
    """Kernel merge_take vs its plain version per call: equal rows, by the
    kernel's float4 path on the call's own table and by its per-element
    path on the table's first C - 1 columns (a width that is not a
    multiple of 4, as a zoo model's could be)."""
    import torch
    from msmdfusion_torch.ops.sparse import merge_take as mt
    out = []
    for i, (args, kwargs) in enumerate(calls):
        table, idx = args[:2]
        idx2, dup = args[2:4] if len(args) > 2 else (None, None)
        got = mt.merge_take_rows(*args, **kwargs)
        want = mt.merge_take_rows_plain(table, idx, idx2, dup)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f'merge_take call {i}: {int((got != want).any(1).sum())} rows '
              'differ from the plain version')
        odd = table[:, :-1].contiguous()
        odd_args = (odd, *args[1:])
        odd_got = mt.merge_take_rows(*odd_args)
        check(not mt.take_vec4(odd, odd_got) and torch.equal(
            odd_got, mt.merge_take_rows_plain(odd, idx, idx2, dup)),
            f'merge_take call {i}: the per-element path at C={odd.shape[1]} '
            'differs from the plain version')
        n, c = table.shape
        m = idx.shape[0]
        rows = int(((idx >= 0) & (idx < n)).sum())
        nbytes = 4 * m                                 # idx
        if dup is not None:
            rows += int(dup.sum())
            nbytes += 5 * m                            # idx2, dup
        nbytes += 4 * c * (rows + m)           # rows read, output written
        rec = dict(
            n=n, c=c, m=m, rows=rows, err=0.0,
            ms=cuda_ms(lambda: mt.merge_take_rows(*args), reps),
            plain_ms=cuda_ms(lambda: mt.merge_take_rows_plain(
                table, idx, idx2, dup), reps),
            library_ms=None, bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=0.0,
            odd_ms=cuda_ms(lambda: mt.merge_take_rows(*odd_args), reps))
        out.append(rec)
        print(f"merge_take[{i}] N={n} C={c} M={m} rows_read={rows} exact "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"bound_ms={rec['bytes_ms']:.4f}; per-element path at "
              f"C={c - 1} exact ms={rec['odd_ms']:.4f} [{card}]", flush=True)
    return out


def kernel_summary(name, recs, launches):
    """One entry of the ``kernels`` line: sums over the path's calls."""
    bytes_ms = sum(r['bytes_ms'] for r in recs)
    ops_ms = sum(r['ops_ms'] for r in recs)
    lib = [r['library_ms'] for r in recs]
    return dict(
        name=name, **KERNEL_INFO[DIRECTIONS.get(name, name)],
        launches=launches[name],
        max_abs_err=max(r['err'] for r in recs),
        ms=sum(r['ms'] for r in recs),
        plain_ms=sum(r['plain_ms'] for r in recs),
        bound_ms=sum(max(r['bytes_ms'], r['ops_ms']) for r in recs),
        bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
        library_ms=None if None in lib else sum(lib), **route_shares(recs),
        **(rows_ratios(recs) if name in ('rows_affine', 'rows_queries')
           else {}))


def route_shares(recs):
    """Of the tensor-core kernels' records: hits over the row-taps or
    pairs they stage (``useful_share``), the packed ones' time over the
    fp32 engine's (x3) kernel's on the same calls (``fp32_ratio``) and the
    x3 ones' over the exact (FFMA) kernel's (``ffma_ratio``), the
    redesigned x3 ones' cuBLAS bf16 yardstick (``bf16mm_ms``) and the x3
    conv's share at the packed conv's 16-row slices (``useful_share16``);
    the exact kernels' (``conv_dw``, ``gather_gemm_conv``, ``match_conv``)
    hits over the row-taps they multiply and their cuBLAS yardstick
    (``sgemm_ms``);
    ``masked_nn``'s bound at the unfused fp32
    rate (``unfused_bound_ms``), where the records carry them."""
    out = {}
    if recs and all('staged' in r for r in recs):
        out['useful_share'] = sum(r['hits'] for r in recs) / max(
            sum(r['staged'] for r in recs), 1)
    if recs and all('fp32_ms' in r for r in recs):
        out['fp32_ratio'] = sum(r['ms'] for r in recs) / sum(
            r['fp32_ms'] for r in recs)
    if recs and all('ffma' in r for r in recs):
        out['ffma_ratio'] = sum(r['ms'] for r in recs) / sum(
            r['ffma']['ms'] for r in recs)
    if recs and all('sgemm_ms' in r for r in recs):
        out['sgemm_ms'] = sum(r['sgemm_ms'] for r in recs)
    if recs and all('bf16mm_ms' in r for r in recs):
        out['bf16mm_ms'] = sum(r['bf16mm_ms'] for r in recs)
    if recs and all('staged16' in r for r in recs):
        out['useful_share16'] = sum(r['hits'] for r in recs) / max(
            sum(r['staged16'] for r in recs), 1)
    if recs and all('unfused_ms' in r for r in recs):
        out['unfused_bound_ms'] = sum(max(r['bytes_ms'], r['unfused_ms'])
                                      for r in recs)
    return out


class PinnedProposals:
    """Inside the scope the TransFusion head takes the given flat proposal
    indices [B, P] (class * H * W + cell) in place of its own top-k, and
    its local-max NMS keeps those cells, so that two paths decode the same
    proposals: where two neighbouring cells lie within rounding of each
    other, one path's NMS may keep the cell that the other's suppresses,
    and the proposal's heatmap score would be 0 in that one."""

    def __init__(self, index):
        self.index = index

    def __enter__(self):
        import torch
        from msmdfusion_torch.models.heads import transfusion_head as th
        self._th = th
        self._orig = top, nms = th.topk_lower_index_first, th.local_maximum_nms

        def kept_nms(heatmap, *a, **k):
            out = nms(heatmap, *a, **k).flatten(1)
            out = out.scatter(1, self.index,
                              heatmap.flatten(1).gather(1, self.index))
            return out.view_as(heatmap)
        th.topk_lower_index_first = lambda x, k: (
            torch.gather(x, 1, self.index), self.index)
        th.local_maximum_nms = kept_nms
        return self

    def __exit__(self, *exc):
        self._th.topk_lower_index_first, self._th.local_maximum_nms = \
            self._orig
        return False


def proposal_index(preds):
    h, w = preds['dense_heatmap'].shape[-2:]
    return preds['query_labels'] * (h * w) + preds['query_spatial']


def check_proposals(head, index, run, ref):
    """The kernel path's proposals ``index`` must be a top-P choice of the
    plain path's heatmap up to TOL: the head's own choice (local-max NMS
    and top-P of the sigmoid, or with image fusion of the mean of two
    sigmoids: ``Selection``) on a heatmap within TOL of the plain one's
    largest value, the limit ``compare_outputs`` holds the dense heatmap
    to. The kernel path's heatmap is that heatmap: the proposals must be
    the head's choice on it (recomputed here) and it must lie so near.
    Both steps of the choice are discontinuous, so the kernel path may
    choose other cells than the plain heatmap's own choice: at the top-P
    cut where two cells lie within TOL, and at the NMS where a cell and its
    neighbour do (a chosen cell there that the plain NMS suppresses scores
    0 in it). Returns (the kernel heatmap's distance over the plain one's
    largest value; how far the best unchosen local maximum of the plain
    heatmap's sigmoid beats its lowest chosen cell, over its largest value,
    a chosen cell that its NMS suppresses counting 0; how many chosen cells
    it suppresses; how many proposals differ from its own choice), all
    printed."""
    import torch
    from msmdfusion_torch.models.heads.transfusion_head import (
        local_maximum_nms, topk_lower_index_first)

    def nms(preds):
        heatmap = preds.get('selection')        # where Selection kept it
        if heatmap is None:
            heatmap = torch.sigmoid(preds['dense_heatmap'])
        return local_maximum_nms(heatmap, head.nms_kernel_size,
                                 head._flat_classes()).flatten(1)
    mine = topk_lower_index_first(nms(run), head.num_proposals)[1]
    check(torch.equal(mine, index), 'the kernel path\'s proposals are not '
          'the head\'s own choice on its heatmap')
    dist = rel_err(run['dense_heatmap'], ref['dense_heatmap'])[1]
    check(dist <= TOL, f'the kernel path\'s heatmap lies {dist:.3g} of max '
          f'from the plain path\'s, above {TOL:.3g}')
    hm = nms(ref)
    scale = float(hm.abs().max())
    chosen = torch.zeros_like(hm, dtype=torch.bool).scatter_(1, index, True)
    lowest = torch.where(chosen, hm, float('inf')).min(dim=1)[0]
    best_left = torch.where(chosen, float('-inf'), hm).max(dim=1)[0]
    excess = float((best_left - lowest).max()) / scale
    suppressed = int((chosen & (hm == 0)).sum())
    own = topk_lower_index_first(hm, head.num_proposals)[1]
    differ = int((~(index[:, :, None] == own[:, None, :]).any(-1)).sum())
    return dist, excess, suppressed, differ


class ReorderedSums:
    """Inside the scope the plain sparse convs sum their taps, and each
    tap's input channels, in the reverse order, and the plain weight
    gradient its rows: the same sums in another fp32 order, a legitimate
    path whose spread from the plain path measures what the model itself
    makes of rounding."""

    def __enter__(self):
        import dataclasses
        from msmdfusion_torch.ops.sparse import matchconv as mc
        self._mc = mc
        self._orig = conv, dw, match = (mc.gather_gemm_conv_plain,
                                        mc.conv_dw_plain, mc.match_conv_plain)

        def flip_taps(plan):
            return dataclasses.replace(plan, inb=plan.inb.flip(1), **{
                k: getattr(plan, k).flip(-1) for k in ('dkey', 'queries')
                if getattr(plan, k) is not None})
        mc.gather_gemm_conv_plain = lambda feats, rows, weights, *a, **k: \
            conv(feats.flip(1), rows.flip(1), weights.flip(0).flip(1),
                 *a, **k)
        mc.conv_dw_plain = lambda feats, rows, g: \
            dw(feats, rows.flip(0), g.flip(0))
        mc.match_conv_plain = lambda feats, keys, plan, weights, *a, **k: \
            match(feats.flip(1), keys, flip_taps(plan),
                  weights.flip(0).flip(1), *a, **k)
        return self

    def __exit__(self, *exc):
        mc = self._mc
        mc.gather_gemm_conv_plain, mc.conv_dw_plain, mc.match_conv_plain = \
            self._orig
        return False


class X3Plain:
    """Inside the scope the plain convs and weight gradient compute the x3
    product wherever the kernels do (``matchconv.x3()`` for the rulebook
    conv and ``dw``, ``match_kernel()`` for the one-hot conv, at the call),
    not the exact one that a CPU tensor takes: the all-plain twin of a path
    on the x3 kernels then differs from it by the order of fp32 sums alone.
    Enter it before ``ReorderedSums`` and ``PinnedRounding.replay()``,
    which call what it leaves in place."""

    NAMES = ('gather_gemm_conv_plain', 'conv_dw_plain', 'match_conv_plain')

    def __enter__(self):
        from msmdfusion_torch.ops.sparse import matchconv as mc
        self._mc = mc
        self._orig = conv, dw, match = [getattr(mc, n) for n in self.NAMES]

        def rulebook():
            return 'x3' if mc.x3() else 'exact'

        def onehot():
            return 'x3' if mc.match_kernel() == 'match_conv_x3' else 'exact'
        mc.gather_gemm_conv_plain = lambda *a, **k: conv(
            *a, **dict(dict(gemm=rulebook()), **k))
        mc.conv_dw_plain = lambda *a, **k: dw(
            *a, **dict(dict(gemm=rulebook()), **k))
        mc.match_conv_plain = lambda *a, **k: match(
            *a, **dict(dict(gemm=onehot()), **k))
        return self

    def __exit__(self, *exc):
        for name, orig in zip(self.NAMES, self._orig):
            setattr(self._mc, name, orig)
        return False


class HeadInput:
    """Keep the BEV map the detection head is called on inside the scope."""

    def __init__(self, head):
        self.head = head
        self.x = None

    def __enter__(self):
        def keep(module, args):
            self.x = args[0].clone()
        self._handle = self.head.register_forward_pre_hook(keep)
        return self

    def __exit__(self, *exc):
        self._handle.remove()
        return False


class Selection:
    """Keep the heatmap the TransFusion head picks its proposals from
    inside the scope: the input of its local-max NMS (the sigmoid of the
    dense heatmap; with image fusion the mean of the LiDAR and the fused
    maps' sigmoids, not an output)."""

    def __enter__(self):
        from msmdfusion_torch.models.heads import transfusion_head as th
        self._th = th
        self._orig = nms = th.local_maximum_nms
        self.heatmap = None

        def keep(heatmap, *a, **k):
            self.heatmap = heatmap.clone()
            return nms(heatmap, *a, **k)
        th.local_maximum_nms = keep
        return self

    def __exit__(self, *exc):
        self._th.local_maximum_nms = self._orig
        return False


def pinned_forward(model, inputs, index, *scopes):
    """(head input, preds, boxes, the heatmap the proposals come from) of
    one forward decoding ``index`` (its own proposals where ``index`` is
    None)."""
    with contextlib.ExitStack() as stack:
        for scope in scopes:
            stack.enter_context(scope)
        if index is not None:
            stack.enter_context(PinnedProposals(index))
        head_in = stack.enter_context(HeadInput(model.pts_bbox_head))
        sel = stack.enter_context(Selection())
        preds, boxes = forward(model, inputs)
    return dict(preds, **boxes, head_input=head_in.x, selection=sel.heatmap)


YAW = 6     # the yaw's column in a box (x, y, z, w, l, h, yaw, vx, vy)


def boxes_part(out, key):
    """``out[key]``, but the boxes without their yaw and the yaw alone
    under 'bboxes' and 'yaw'."""
    import torch
    if key == 'yaw':
        return out['bboxes'][..., YAW]
    if key == 'bboxes':
        b = out['bboxes']
        return torch.cat([b[..., :YAW], b[..., YAW + 1:]], -1)
    return out[key]


def compare_outputs(run, ref, alt, at_tol=('head_input', 'dense_heatmap')):
    """The kernel path ``run`` vs the plain path ``ref`` on the same
    proposals; ``alt`` is the plain path with reordered sums. Returns
    {key: (error over max |ref|, its limit, the same for ``alt``, median
    |ref|)}.

    Up to the head (its input and the dense heatmap) every output is held
    to TOL of its largest value. The decoder's attention then amplifies
    rounding (softmax over logits of tens), so its outputs and the boxes
    are held to FLOOR_MARGIN times the plain path's own spread under
    reordered sums, and never less than TOL. A box's yaw is the angle of
    the head's ``rot`` (sine, cosine), which moves by the error over
    ``rot``'s length, so that where the decoder gives a box a short
    ``rot`` the angle's error is the product of that box's rounding alone,
    not of the spread: the boxes are held without it, and ``rot`` itself
    is held; the yaw is returned, not held, with its limit as NaN.
    ``at_tol``: the outputs held to TOL (the others to the spread)."""
    import torch
    worst = {}
    for key in ('head_input', 'dense_heatmap', 'heatmap', 'center', 'dim',
                'rot', 'bboxes', 'scores', 'yaw'):
        got, want, other = (boxes_part(out, key) for out in (run, ref, alt))
        rel = rel_err(got, want)[1]
        floor = rel_err(other, want)[1]
        limit = TOL if key in at_tol else max(TOL, FLOOR_MARGIN * floor)
        if key == 'yaw':
            limit = float('nan')
        worst[key] = (rel, limit, floor, float(want.abs().median()))
        if rel > limit:
            diff = (got - want).abs()
            at = tuple(int(i) for i in torch.unravel_index(diff.argmax(),
                                                           diff.shape))
            check(False, f'{key}: kernel vs plain path {rel:.3g} of max '
                  f'|ref|, above {limit:.3g} (reordered plain path '
                  f'{floor:.3g}); worst at {at}: {float(got[at]):.6g} '
                  f'against {float(want[at]):.6g}')
    for key in ('labels', 'valid'):
        check(torch.equal(run[key], ref[key]),
              f'{key} differ between the kernel and plain paths')
    return worst


def profile_forward(fn, top=8):
    """``fn()`` once under torch.profiler: (host window ms, device busy ms,
    [(device ms, kernel name)] of the ``top`` kernels). Busy time is the
    union of the device events' spans (CUPTI's own buffer events and the
    device-side spans of annotated regions, such as ``Optimizer.step``,
    left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, 'is_user_annotation', False)
                or evt.name in ('Buffer Flush', 'Activity Buffer Request')):
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        by_name[evt.name] = by_name.get(evt.name, 0.0) + \
            (evt.time_range.end - evt.time_range.start) / 1e3
    busy_us, reach = 0.0, float('-inf')
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    ranked = sorted(((ms, name) for name, ms in by_name.items()),
                    reverse=True)[:top]
    return window_ms, busy_us / 1e3, ranked


def check_launches(label, launches, expected):
    """Every kernel in ``expected`` launched that many times (never 0),
    every other kernel not at all."""
    for name, n in launches.items():
        check(n == expected.get(name, 0), f'{label}: {name} launched {n} '
              f'times, expected {expected.get(name, 0)}')


def drive(label, model, inputs, spec, card, reps, fp32=None):
    """Run the path described in the module docstring on one model
    (``fp32``: {kernel: the fp32 kernel's records of the same calls}).
    Returns ({kernel: per-call records}, {kernel: launches})."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.utils import overflow, timing
    expected = spec['launches']

    # the path's kernel calls, each against its plain version
    with torch.no_grad(), Recorder() as rec:
        forward(model, inputs)
    torch.cuda.synchronize()
    recorded = {k: len(v) for k, v in rec.calls.items() if v}
    check(recorded == as_recorded(expected),
          f'{label}: recorded calls {recorded}, expected '
          f'{as_recorded(expected)}')
    recs = {}
    with torch.no_grad():
        if rec.calls['rows_affine']:
            recs['rows_affine'] = rows_calls(
                'rows_affine', rec.calls['rows_affine'], reps['kernel'], card)
        for wrapper in ('gather_gemm_conv', 'match_conv'):
            if rec.calls[wrapper]:
                name = kernel_of(wrapper)
                recs[name] = conv_calls(
                    rec.calls[wrapper], spec['widths'], reps['kernel'] // 2,
                    card, fp32=(fp32 or {}).get(name))
                if name in FFMA:
                    # the exact (FFMA) kernel on the same calls
                    recs[FFMA[name]] = [r['ffma'] for r in recs[name]]
        if rec.calls['masked_nn']:
            recs['masked_nn'] = nn_calls(rec.calls['masked_nn'],
                                         reps['kernel'], card)
        if rec.calls['merge_take']:
            recs['merge_take'] = take_calls(rec.calls['merge_take'],
                                            reps['kernel'], card)
    del rec
    sums_lines(f'{label}: %s sums over one frame', recs, card)

    # the main path through the kernels, counted
    with torch.no_grad():
        kernels.reset_launches()
        with overflow.capture() as cap, timing.record('cuda') as tr:
            preds, boxes = forward(model, inputs)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
    print(f'{label}: launches on the main path: {launches}', flush=True)
    check_launches(label, launches, expected)
    check_frame(label, model, cap, boxes, spec.get('overflow', {}))
    stage_ms = {k: round(v, 4) for k, v in tr.ms().items()}
    print(f'{label}: stage_ms {json.dumps(stage_ms)} [{card}]', flush=True)
    host_ms = {k: round(v, 4) for k, v in tr.host_ms().items()}
    print(f'{label}: stage ms by the host clock {json.dumps(host_ms)} '
          f'[{card}]', flush=True)

    # the kernel path once more, keeping its conv operands, and the same
    # forward on the plain versions (and with reordered sums) replaying
    # them and decoding that kernel forward's proposals: a near-tie at the
    # top-k cut or at the local-max NMS may not swap or drop one. The x3
    # and packed routes turn the port's
    # ulp-level run-to-run noise into rounding steps, so the counted
    # forward above is not the execution the twin replays; how far it lies
    # from it is printed, not held
    with torch.no_grad():
        pins = PinnedRounding()
        run = pinned_forward(model, inputs, None, pins)
        index = proposal_index(run)
        ref = pinned_forward(model, inputs, index, kernels.plain_kernels(),
                             X3Plain(), pins.replay())
        alt = pinned_forward(model, inputs, index, kernels.plain_kernels(),
                             X3Plain(), ReorderedSums(), pins.replay())
        dist, excess, suppressed, differ = check_proposals(
            model.pts_bbox_head, index, run, ref)
        worst = compare_outputs(run, ref, alt)
        again = rel_err(preds['dense_heatmap'], run['dense_heatmap'])[1]
        moved = int((~(proposal_index(preds)[:, :, None]
                       == index[:, None, :]).any(-1)).sum())
        del run, ref, alt, pins
    print(f'{label}: the counted forward against the one the twin replays: '
          f'dense_heatmap {again:.3g} of max, {moved} proposals differ',
          flush=True)
    for key, (rel, limit, floor, median) in worst.items():
        held = 'not held' if key == 'yaw' else f'limit {limit:.3g}'
        print(f'{label}: kernel vs plain path: {key} {rel:.3g} of max |ref| '
              f'({held}; plain path with reordered sums '
              f'{floor:.3g}; median |ref| {median:.3g})', flush=True)
    print(f'{label}: proposals: the head\'s top-'
          f'{model.pts_bbox_head.num_proposals} on the kernel heatmap, '
          f'{dist:.3g} of max from the plain one (limit {TOL:.3g}); on the '
          f'plain heatmap: worst excess {excess:.3g} of max, {suppressed} '
          f'chosen cells its NMS suppresses, {differ} differ from its own '
          'choice', flush=True)

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        frame_ms = cuda_ms(lambda: forward(model, inputs), reps['frame'])
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        for _ in range(reps['frame']):
            forward(model, inputs)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / reps['frame'] * 1e3
        with kernels.plain_kernels():
            plain_frame_ms = cuda_ms(lambda: forward(model, inputs), 2)
    print(f'{label}: e2e {frame_ms:.3f} ms/frame (CUDA events, '
          f'{reps["frame"]} frames), {1e3 / frame_ms:.2f} frames/s; host '
          f'clock {host_ms:.3f} ms/frame; plain versions '
          f'{plain_frame_ms:.3f} ms/frame; peak memory {peak_gb:.2f} GiB '
          f'[{card}]', flush=True)
    with torch.no_grad():
        window_ms, busy_ms, ranked = profile_forward(
            lambda: forward(model, inputs))
    check(busy_ms > 0, f'{label}: the profiler saw no device work')
    print(f'{label}: profile: one forward {window_ms:.3f} ms host window, '
          f'device busy {busy_ms:.3f} ms, idle share '
          f'{1 - busy_ms / window_ms:.3f} [{card}]', flush=True)
    for ms, name in ranked:
        print(f'{label}: profile: {ms:9.3f} ms  {name[:100]}', flush=True)
    return recs, launches


def check_frame(label, model, cap, boxes, overflow=None):
    """A counted frame's checks: rows dropped only where ``overflow``
    ({site: rows}, the configuration's own cap) says, finite boxes of the
    coder's width (9 with a velocity, else 7), scores in [0, 1]; prints
    the occupancy gauges."""
    import torch
    dropped = {k: v for k, v in cap.counters().items() if v}
    check(dropped == (overflow or {}),
          f'{label}: overflow {dropped}, expected {overflow or {}}')
    head = model.pts_bbox_head
    b = boxes['bboxes']
    width = 9 if head.coder.code_size == 10 else 7
    check(b.shape[-1] == width and b.shape[1] == head.num_proposals,
          f'{label}: bboxes shape {tuple(b.shape)}')
    check(bool(torch.isfinite(b).all()), f'{label}: non-finite boxes')
    s = boxes['scores']
    check(bool(((s >= 0) & (s <= 1)).all()), f'{label}: scores outside [0, 1]')
    occupancy = {k: v for k, v in cap.gauge_values().items()
                 if k.startswith('occ.')}
    print(f'{label}: overflow {dropped or 0} (every other site 0); '
          f'occupancy {occupancy}', flush=True)


def sums_lines(what, recs, card):
    """One line per kernel of ``recs``: its calls, their summed ms, plain
    ms and bound, and its route's shares; ``what`` % the kernel's name
    leads the line."""
    for name, rs in recs.items():
        extra = ''.join(f'{k}={v:.3f} ' for k, v in route_shares(rs).items())
        print(f'{what % name}: {len(rs)} calls, '
              f'ms={sum(r["ms"] for r in rs):.3f} '
              f'plain_ms={sum(r["plain_ms"] for r in rs):.3f} bound_ms='
              f'{sum(max(r["bytes_ms"], r["ops_ms"]) for r in rs):.3f} '
              f'{extra}[{card}]', flush=True)


def path_outputs(model, inputs):
    """A path's own proposals and its head input, heatmap and boxes on
    them, for another path's comparison."""
    import torch
    with torch.no_grad():
        index = proposal_index(forward(model, inputs)[0])
        run = pinned_forward(model, inputs, index)
    return {k: run[k] for k in ('head_input', 'dense_heatmap', 'bboxes',
                                'scores')} | dict(index=index)


def path_vs(label, model, inputs, ref):
    """How far the path the switches pick lies from another path
    (``path_outputs``) on that path's proposals, and how many of its own
    proposals differ (printed, not held: another rounding)."""
    import torch
    with torch.no_grad():
        own = proposal_index(forward(model, inputs)[0])
        run = pinned_forward(model, inputs, ref['index'])
    differ = int((~(own[:, :, None] == ref['index'][:, None, :])
                  .any(-1)).sum())
    for key in ('head_input', 'dense_heatmap', 'bboxes', 'scores'):
        err, rel = rel_err(run[key], ref[key])
        print(f'{label}: {key} {err:.4g} ({rel:.4g} of max |ref|) on its '
              'proposals', flush=True)
    print(f'{label}: {differ} of {own.numel()} own proposals differ',
          flush=True)


def highest_frame(label, model, inputs, card, expected):
    """A frame of the engine the switches pick on the exact fp32 product
    (``MSMD_CONV_GEMM=highest``, set around it only): the FFMA kernel's
    launches on the main path, counted and held to ``expected``, no row
    dropped; then how far the default x3 path lies from it (printed, not
    held). Returns its launches."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.utils import overflow
    with switches(HIGHEST['env']), torch.no_grad():
        kernels.reset_launches()
        with overflow.capture() as cap:
            forward(model, inputs)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
        print(f'{label} highest: launches on the main path: {launches}',
              flush=True)
        check_launches(f'{label} highest', launches, expected)
        check(cap.total() == 0, f'{label} highest: overflow '
              f'{cap.counters()}')
        exact = path_outputs(model, inputs)
    path_vs(f'{label} x3 vs exact (highest) path [{card}]', model, inputs,
            exact)
    return launches


def dense_engines(model, inputs, card, reps=3):
    """The dense layers new to the flagship at its shapes, timed on cuDNN
    and on PyTorch's own convolution (cuDNN off) under the global flag:
    the check behind ``models/layers.py::cudnn_enabled``'s choices; the
    image branch also with bf16 parameters on bf16 images."""
    import copy
    import torch
    from msmdfusion_torch.models.layers import cast_params
    img = inputs[2]
    b, v, h, w, _ = img.shape
    backbone = model.img_backbone
    # the image branch with its parameters cast to bf16, on bf16 images:
    # the dense layers that run bf16 in phase 8's cast frames (the
    # compression convs, SPP and SECOND take fp32 inputs there too)
    backbone16 = cast_params(copy.deepcopy(backbone))
    neck16 = cast_params(copy.deepcopy(model.img_neck))

    def resnet_body(x, net=backbone):
        # ResNet.forward's layers without its own choice of engine
        x = net.maxpool(torch.relu(net.bn1(net.conv1(x))))
        for s in range(net.num_stages):
            x = getattr(net, f'layer{s + 1}')(x)
        return x

    with torch.no_grad():
        x = img.reshape(b * v, h, w, 3).permute(0, 3, 1, 2).contiguous()
        x16 = x.to(torch.bfloat16)
        feats16 = backbone16(x16)
        level0 = model.img_neck(backbone(x))[0]
        comp_in = torch.cat([level0, level0[:, :1]], 1)
        c_bev = model.bev_fusion.conv1x1[0].in_channels
        bev = torch.randn(1, c_bev, 180, 180, device=img.device)
        spp = model.bev_fusion
        cases = [
            (f'ResNet-50 {b * v}x3x{h}x{w}', lambda: resnet_body(x)),
            (f'compress {comp_in.shape[1]}->49 5x5 at '
             f'{level0.shape[2]}x{level0.shape[3]}',
             lambda: model.conv1x1_blocks[0](comp_in)),
            (f'SPP 3x3 {c_bev}->256 at 180x180', lambda: spp.conv3x3(bev)),
            (f'SPP 3x3 dilation 6 {c_bev}->256 at 180x180',
             lambda: spp.dilated_conv3x3_rate6(bev)),
            (f'SPP 3x3 dilation 12 {c_bev}->256 at 180x180',
             lambda: spp.dilated_conv3x3_rate12(bev)),
            (f'ResNet-50 bf16 {b * v}x3x{h}x{w}',
             lambda: resnet_body(x16, backbone16)),
            (f'FPN bf16 at {b * v} images', lambda: neck16(feats16)),
        ]
        engine_lines(cases, card, reps)


def engine_lines(cases, card, reps=3):
    """Each (name, fn) of ``cases`` timed on cuDNN, off it and on it again
    (the global flag), one line each."""
    import torch
    was = torch.backends.cudnn.enabled
    try:
        for name, fn in cases:
            times = []
            for on in (True, False, True):
                torch.backends.cudnn.enabled = on
                times.append(cuda_ms(fn, reps))
            print(f'dense engines: {name}: cuDNN {times[0]:.3f} / '
                  f'{times[2]:.3f} ms, off cuDNN {times[1]:.3f} ms '
                  f'[{card}]', flush=True)
    finally:
        torch.backends.cudnn.enabled = was


def lc_dense_engines(model, inputs, card, reps=3):
    """The dense layers new to TransFusion-LC at its shapes, on and off
    cuDNN: the head's ``shared_conv_img`` over the views' FPN level 0,
    the FPN itself in fp32 and the fused heatmap's convs on the BEV."""
    import torch
    head = model.pts_bbox_head
    with torch.no_grad():
        img = inputs[2]
        b, v, h, w, _ = img.shape
        x = img.reshape(b * v, h, w, 3).permute(0, 3, 1, 2).contiguous()
        feats = model.img_backbone(x)
        level0 = model.img_neck(feats)[0]
        gh, gw = head._bev_shape()
        bev = torch.randn(1, head.shared_conv.out_channels, gh, gw,
                          device=img.device)
        engine_lines([
            (f'shared_conv_img {level0.shape[1]}->'
             f'{head.shared_conv_img.out_channels} 3x3 at {b * v}x'
             f'{level0.shape[2]}x{level0.shape[3]}',
             lambda: head.shared_conv_img(level0)),
            (f'FPN fp32 at {b * v} images', lambda: model.img_neck(feats)),
            (f'heatmap_head_img at {gh}x{gw}',
             lambda: head.heatmap_head_img(bev))], card, reps)


class HeadGrad:
    """Inside the scope keep the gradient that reaches the detection
    head's input (``grad``) and, with ``replace``, hand the backward
    ``replace`` in its place: the backward below the head then starts from
    the same gradient in two paths."""

    def __init__(self, head, replace=None):
        self.head, self.replace, self.grad = head, replace, None

    def __enter__(self):
        def keep(grad):
            self.grad = grad.detach().clone()
            return self.replace

        def pre(module, args):
            if args[0].requires_grad:
                args[0].register_hook(keep)
        self._handle = self.head.register_forward_pre_hook(pre)
        return self

    def __exit__(self, *exc):
        self._handle.remove()
        return False


class ReluMasks:
    """Inside the scope every ReLU called through ``torch.relu``,
    ``F.relu`` or ``nn.ReLU`` (all of those below the detection head)
    records its mask ``x > 0`` (``masks`` None) or, given another pass's
    ``masks``, applies them in call order. At full scale every layer has
    inputs within fp32 rounding of 0, and the gradient passes one side of
    such a ReLU and not the other: a second pass that takes the first
    one's masks makes the same decisions, so that the backward is a smooth
    function of the values the two paths compute."""

    def __init__(self, masks=None):
        self.replay = masks is not None
        self.masks = [] if masks is None else masks
        self.calls = 0

    def relu(self, x, inplace=False):
        import torch
        del inplace
        if self.replay:
            mask = self.masks[self.calls]
            check(mask.shape == x.shape, f'ReLU call {self.calls}: shape '
                  f'{tuple(x.shape)}, recorded {tuple(mask.shape)}')
            out = torch.where(mask, x, 0.0)
        else:
            self.masks.append(x > 0)
            out = self._orig[0](x)
        self.calls += 1
        return out

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        self._orig = (torch.relu, F.relu, torch.nn.ReLU.forward)
        torch.relu = F.relu = self.relu
        torch.nn.ReLU.forward = lambda module, x: self.relu(x)
        return self

    def __exit__(self, *exc):
        import torch
        import torch.nn.functional as F
        torch.relu, F.relu, torch.nn.ReLU.forward = self._orig
        check(exc[0] is not None or not self.replay
              or self.calls == len(self.masks),
              f'{self.calls} ReLU calls, {len(self.masks)} masks recorded')
        return False


class PinnedRounding:
    """The rounding decisions of the rulebook engine's tensor-core routes,
    pinned like the ReLU masks. Each packed conv rounds its input features
    (in the backward the gradient, and both operands of ``dw``) to bf16,
    and each x3 conv splits them into bf16 hi + lo; so an fp32 sum one ulp
    apart in two paths (another order of the sums) can round to
    neighbouring bf16 values, 2^-8 apart, or split into another hi/lo pair
    whose product moves by up to ~2^-17 (the dropped lo.lo and lo's own
    rounding), and a deep stack of such convs turns fp32 ulps into those
    steps (the x3 path and its x3 twin, unpinned: 5-9e-5 of the head
    input's largest value on an H100 at full scale, against 1e-5 for the
    exact kernels and their exact twin). Inside the scope, on the packed
    or an x3 route (the rulebook engine's or the one-hot one's,
    ``x3_route()``), the kernel path's ``gather_gemm_conv``, ``conv_dw``
    and ``match_conv`` calls keep their operands (as rounded to bf16,
    packed; as given, x3), in call order; inside ``replay()`` each plain
    ``gather_gemm_conv_plain``/``conv_dw_plain``/``match_conv_plain`` call
    takes those values wherever its own lie within one step of them (one
    bf16 step, packed; 2^-16 of the binade, x3), so that both paths
    multiply the same bf16 operands and differ by fp32 sum order alone. On
    the exact routes both scopes do nothing."""

    def __init__(self, kept=None, bits=None):
        from msmdfusion_torch.ops.sparse import matchconv as mc
        self.replaying = kept is not None
        self.kept = [] if kept is None else kept
        # the operands' resolution on the route: 8 bits (bf16), 16 (x3)
        self.bits = bits if self.replaying else (
            8 if mc.packed() else 16 if x3_route() else None)
        self.calls = 0

    def replay(self):
        return PinnedRounding(self.kept, self.bits)

    def _step(self, x):
        """One step of the route's resolution at |x|: 2^-bits of the
        binade."""
        import torch
        return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - self.bits)

    def _pin(self, x):
        import torch
        from msmdfusion_torch.ops.sparse import matchconv as mc
        kept = self.kept[self.calls].to(torch.float32)
        check(kept.shape == x.shape, f'pinned rounding call {self.calls}: '
              f'shape {tuple(x.shape)}, kept {tuple(kept.shape)}')
        self.calls += 1
        mine = mc.bf16_round(x) if self.bits == 8 else x.float()
        near = (mine - kept).abs() <= self._step(
            torch.maximum(mine.abs(), kept.abs()))
        # bf16 operands (the bf16-compute step's) stay bf16: the kept
        # values are theirs, so the cast back is exact
        return torch.where(near, kept, x.float()).to(x.dtype)

    def _keep(self, x):
        import torch
        from msmdfusion_torch.ops.sparse import matchconv as mc
        self.kept.append(mc.bf16_round(x).to(torch.bfloat16)
                         if self.bits == 8 else x.detach().clone())

    def __enter__(self):
        from msmdfusion_torch.ops.sparse import matchconv as mc
        self._mc = mc
        if self.bits is None:
            return self
        if self.replaying:
            names = ('gather_gemm_conv_plain', 'conv_dw_plain',
                     'match_conv_plain')
            conv, dw, match = self._orig = [getattr(mc, n) for n in names]
            mc.gather_gemm_conv_plain = lambda feats, *a, **k: \
                conv(self._pin(feats), *a, **k)
            mc.conv_dw_plain = lambda feats, rows, g: \
                dw(self._pin(feats), rows, self._pin(g))
            mc.match_conv_plain = lambda feats, *a, **k: \
                match(self._pin(feats), *a, **k)
        else:
            names = ('gather_gemm_conv', 'conv_dw', 'match_conv')
            conv, dw, match = self._orig = [getattr(mc, n) for n in names]

            def kept_conv(feats, *a, **k):
                self._keep(feats)
                return conv(feats, *a, **k)

            def kept_dw(feats, rows, g, **k):
                self._keep(feats)
                self._keep(g)
                return dw(feats, rows, g, **k)

            def kept_match(feats, *a, **k):
                self._keep(feats)
                return match(feats, *a, **k)
            mc.gather_gemm_conv, mc.conv_dw, mc.match_conv = \
                kept_conv, kept_dw, kept_match
        self._names = names
        return self

    def __exit__(self, *exc):
        if self.bits is None:
            return False
        for name, orig in zip(self._names, self._orig):
            setattr(self._mc, name, orig)
        check(exc[0] is not None or not self.replaying
              or self.calls == len(self.kept),
              f'{self.calls} pinned rounding calls, {len(self.kept)} kept')
        return False


def train_pass(model, inputs, gt, rec=None, targets=None, index=None,
               head_grad=None, scopes=()):
    """One training-mode forward, loss and backward (no update), with the
    dropout masks of step 0. ``targets``/``index``/``head_grad``: another
    path's assignment, proposals and head-input gradient to reuse (ReLU
    masks come in ``scopes``). Returns dict(losses, targets, index,
    head_grad (this path's own), grads)."""
    import torch
    from msmdfusion_torch.apis.train import dropout_generator, total_loss
    head = model.pts_bbox_head
    with contextlib.ExitStack() as stack:
        for scope in scopes:
            stack.enter_context(scope)
        if index is not None:
            stack.enter_context(PinnedProposals(index))
        hg = stack.enter_context(HeadGrad(head, head_grad))
        model.zero_grad(set_to_none=True)
        preds = model(*inputs, generator=dropout_generator(
            inputs[0].device, SEED, 0))
        if targets is None:
            targets = head.get_targets(preds, *gt)
        losses = model.loss(preds, *gt, targets=targets)
        if rec is not None:
            rec.phase = 'backward'
        total_loss(losses).backward()
        if rec is not None:
            rec.phase = 'forward'
    torch.cuda.synchronize()
    return dict(losses={k: v.detach() for k, v in losses.items()},
                targets=targets, index=proposal_index(preds),
                head_grad=hg.grad,
                grads={n: p.grad.detach().clone()
                       for n, p in model.named_parameters()
                       if p.grad is not None})


def compare_train(run, ref, alt, spread_only=False):
    """The kernel path's step ``run`` vs the plain path ``ref`` (same
    proposals, assignment, dropout masks and head-input gradient); ``alt``
    is the plain path with reordered sums. Up to the head's input, the
    dense-heatmap loss (computed before the decoder) and every parameter
    gradient below the head (whose backward starts from the same
    head-input gradient in both paths) are held to TOL of their largest
    value. The decoder amplifies rounding, so its losses, the head-input
    gradient before its replacement and the head's parameter gradients
    are held to FLOOR_MARGIN times the plain path's own spread, never less
    than TOL; with ``spread_only`` (the bf16-compute step, whose bf16
    roundings turn fp32 ulps into bf16 steps below the head too) every
    value is. Returns [(error over max |ref|, limit, spread, name)],
    worst first by error over limit."""
    rows = []

    def held(name, got, want, other):
        rel = rel_err(got, want)[1]
        floor = rel_err(other, want)[1]
        below_head = not spread_only and (name == 'loss_heatmap' or (
            '.' in name and not name.startswith('pts_bbox_head.')))
        limit = TOL if below_head else max(TOL, FLOOR_MARGIN * floor)
        rows.append((rel, limit, floor, name))

    for key in run['losses']:
        if 'loss' in key:
            held(key, run['losses'][key], ref['losses'][key],
                 alt['losses'][key])
    held('head_input_grad', run['head_grad'], ref['head_grad'],
         alt['head_grad'])
    check(set(run['grads']) == set(ref['grads']),
          'the kernel and plain paths give gradients to different '
          'parameters')
    for name, want in ref['grads'].items():
        held(name, run['grads'][name], want, alt['grads'][name])
    rows.sort(key=lambda r: r[0] / r[1], reverse=True)
    return rows


def optimized(model, opt):
    """[(name, parameter)] of the model's parameters in ``opt``."""
    ids = {id(p) for g in opt.param_groups for p in g['params']}
    return [(n, p) for n, p in model.named_parameters() if id(p) in ids]


def drive_train(model, inputs, gt, card, spec=TRAIN,
                label='MSMDFusion train', fp32=None, recipe=TRAIN):
    """Phase 5 (see the module docstring) on the calibrated flagship, with
    the launches, timed steps and checks of ``spec`` (phases 6 and 7 skip
    the twin or the extras: free ReLUs, cuDNN on and off, the profile;
    phase 11 runs it on TransFusion-L) and the optimizer, schedule and
    frozen modules of ``recipe``; the counted step must drop the rows of
    ``spec['overflow']`` ({site: rows}, default none).
    ``fp32``: {kernel: the fp32 kernel's records of the same calls}.
    Returns ({kernel: per-call records}, {kernel: launches of one step})."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.train import (build_lr_schedule,
                                             build_optimizer,
                                             dropout_generator,
                                             make_train_step, total_loss)
    from msmdfusion_torch.models.layers import cudnn_enabled
    from msmdfusion_torch.utils import overflow
    head = model.pts_bbox_head
    frozen = recipe['frozen']
    schedule = build_lr_schedule(recipe['lr_config'],
                                 recipe['optimizer']['lr'],
                                 recipe['total_steps'],
                                 recipe['steps_per_epoch'])
    opt = build_optimizer(model, recipe['optimizer'],
                          recipe['optimizer_config'], schedule,
                          frozen_prefixes=frozen)
    model.train()
    check(head.training and ('img_backbone' not in frozen
                             or not model.img_backbone.training),
          f'{label}: the frozen image branch must stay in eval mode')
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def restore_buffers():
        """Undo the norm-statistics updates of the checking passes."""
        with torch.no_grad():
            for name, b in model.named_buffers():
                b.copy_(start[name])

    # one step's kernel calls, each against its plain version
    relu = ReluMasks()
    pins = PinnedRounding()
    with Recorder() as rec:
        run = train_pass(model, inputs, gt, rec=rec, scopes=[relu, pins])
    restore_buffers()
    recorded = {k: (len(rec.calls_in(k, 'forward')),
                    len(rec.calls_in(k, 'backward'))) for k in rec.calls}
    print(f'{label}: recorded calls (forward, backward): {recorded}',
          flush=True)
    want = spec['launches']
    totals = {k: sum(v) for k, v in recorded.items() if sum(v)}
    check(totals == as_recorded(want) and recorded['rows_queries'][1] == 0
          and recorded['conv_dw'][0] == 0,
          f'{label}: recorded calls {recorded}, expected '
          f'{as_recorded(want)} (rows_queries in the forward, conv_dw in '
          'the backward)')
    check(not any(n.startswith(frozen) for n in run['grads']),
          f'{label}: a frozen image parameter got a gradient')
    recs = {}
    with torch.no_grad():
        if rec.calls['rows_queries']:
            recs['rows_queries'] = rows_calls(
                'rows_queries', rec.calls['rows_queries'], 10, card)
        if rec.calls_in('rows_affine', 'backward'):
            recs['rows_affine_bwd'] = rows_calls(
                'rows_affine', rec.calls_in('rows_affine', 'backward'), 5,
                card)
        fp32 = fp32 or {}
        recs[kernel_of('conv_dw')] = dw_calls(
            rec.calls['conv_dw'], 5, card, fp32=fp32.get(kernel_of('conv_dw')))
        # the backward's convs (d_feats); the one-hot forward's too
        for wrapper, phase in (('gather_gemm_conv', 'backward'),
                               ('match_conv', 'forward'),
                               ('match_conv', 'backward')):
            calls = rec.calls_in(wrapper, phase)
            if calls:
                name = kernel_of(wrapper) + ('_bwd' if phase == 'backward'
                                             else '_fwd')
                recs[name] = conv_calls(calls, set(), 5, card, label=name,
                                        fp32=fp32.get(name))
        # the exact (FFMA) kernels on the x3 kernels' calls
        for x3, ffma in (('conv_dw_x3', 'conv_dw'),
                         ('gather_gemm_conv_x3_bwd', 'gather_gemm_conv_bwd'),
                         ('match_conv_x3_fwd', 'match_conv_fwd'),
                         ('match_conv_x3_bwd', 'match_conv_bwd')):
            if x3 in recs:
                recs[ffma] = [r['ffma'] for r in recs[x3]]
    del rec
    sums_lines(f'{label}: %s sums over one step', recs, card)

    if spec['twin']:
        # the same step on the plain versions (and with reordered sums), on
        # the kernel path's proposals, assignment, dropout masks, head-input
        # gradient and ReLU masks
        pinned = dict(targets=run['targets'], index=run['index'],
                      head_grad=run['head_grad'])
        ref = train_pass(model, inputs, gt, scopes=[
            kernels.plain_kernels(), X3Plain(), ReluMasks(relu.masks),
            pins.replay()], **pinned)
        restore_buffers()
        alt = train_pass(model, inputs, gt, scopes=[
            kernels.plain_kernels(), X3Plain(), ReorderedSums(),
            ReluMasks(relu.masks), pins.replay()], **pinned)
        restore_buffers()
        if spec['extras']:
            # what the masks are for: the kernel path once more with its
            # ReLUs free (not asserted)
            free = train_pass(model, inputs, gt, **pinned)
            restore_buffers()
            spread = sorted(((rel_err(free['grads'][n], g)[1], n)
                             for n, g in run['grads'].items()
                             if not n.startswith('pts_bbox_head.')),
                            reverse=True)
            print(f'{label}: the kernel path against itself with free '
                  f'ReLUs: {sum(s <= TOL for s, _ in spread)} of '
                  f'{len(spread)} parameter gradients below the head within '
                  f'{TOL}, worst {spread[0][0]:.3g} of max |ref| '
                  f'({spread[0][1]})', flush=True)
            del free
        rows = compare_train(run, ref, alt)
        losses = {k: round(float(v), 6) for k, v in run['losses'].items()}
        print(f'{label}: losses {json.dumps(losses)}', flush=True)
        for rel, limit, floor, name in rows[:8]:
            print(f'{label}: kernel vs plain path: {name} {rel:.3g} of max '
                  f'|ref| (limit {limit:.3g}; reordered plain path '
                  f'{floor:.3g})', flush=True)
        for group, keep in (
                ('losses and head-input gradient',
                 lambda n: 'loss' in n or n == 'head_input_grad'),
                ('parameter gradients of the head',
                 lambda n: n.startswith('pts_bbox_head.')),
                ('parameter gradients below the head',
                 lambda n: '.' in n and not n.startswith('pts_bbox_head.'))):
            sel = [r for r in rows if keep(r[3])]
            worst = max(r[0] for r in sel)
            over_spread = max(r[0] / max(r[2], 1e-30) for r in sel)
            print(f'{label}: {len(sel)} {group}: worst {worst:.3g} of max '
                  f'|ref|, {sum(r[0] <= TOL for r in sel)} within {TOL}; '
                  f'worst over the reordered spread {over_spread:.3g}',
                  flush=True)
        bad = [r for r in rows if r[0] > r[1]]
        check(not bad, f'{label}: kernel vs plain path above the limit: '
              f'{bad[:5]}')
        del ref, alt
    del run, relu, pins

    # the main path: one step through make_train_step, counted
    restore_buffers()
    batch = dict(inputs=inputs, gt_bboxes=gt[0], gt_labels=gt[1],
                 gt_valid=gt[2])
    train_step = make_train_step(model, opt, seed=SEED)
    trainable = optimized(model, opt)
    kernels.reset_launches()
    with overflow.capture() as cap:
        metrics = train_step(batch, 0)
    launches = dict(kernels.launches)
    torch.cuda.synchronize()
    print(f'{label}: launches of one step: {launches}', flush=True)
    check_launches(label, launches, want)
    dropped = {k: v for k, v in cap.counters().items() if v}
    check(dropped == spec.get('overflow', {}),
          f'{label}: overflow {dropped}, expected {spec.get("overflow", {})}')
    check(bool(torch.isfinite(metrics['total_loss'])),
          f'{label}: non-finite loss')
    print(f'{label}: overflow {dropped or 0} (every other site 0); step 0 '
          'total_loss '
          f'{float(metrics["total_loss"]):.6f} grad_norm '
          f'{float(metrics["grad_norm"]):.6f} lr {schedule(0):.3g}',
          flush=True)

    # AdamW steps, timed: forward (with the assignment), backward,
    # optimizer, by CUDA events; the first is a warm-up
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split, host, auction = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(1, spec['steps'] + 2):
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        preds = model(*inputs, generator=dropout_generator(
            inputs[0].device, SEED, step))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        targets = head.get_targets(preds, *gt)
        torch.cuda.synchronize()
        auction.append((time.perf_counter() - t1) * 1e3)
        losses = model.loss(preds, *gt, targets=targets)
        total = total_loss(losses)
        events[1].record()
        total.backward()
        events[2].record()
        opt.step()
        events[3].record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        split.append([events[i].elapsed_time(events[i + 1])
                      for i in range(3)])
        check(bool(torch.isfinite(total)), f'{label}: step {step} loss '
              'is not finite')
        print(f'{label}: step {step} total_loss '
              f'{float(total.detach()):.6f}', flush=True)
        del preds, losses, total
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd, bwd, upd = (sum(s[i] for s in split[1:]) / spec['steps']
                     for i in range(3))
    print(f'{label}: step {fwd + bwd + upd:.3f} ms = forward {fwd:.3f} '
          f'(the assignment {sum(auction[1:]) / spec["steps"]:.3f} of '
          f'it, host clock) + backward {bwd:.3f} + optimizer {upd:.3f} '
          f'(CUDA events, mean of {spec["steps"]} steps after a warm-up); '
          f'host clock {sum(host[1:]) / spec["steps"]:.3f} ms/step; peak '
          f'memory {peak_gb:.2f} GiB [{card}]', flush=True)

    moved = sum(not torch.equal(p, start[n]) for n, p in trainable)
    check(moved >= 0.9 * len(trainable),
          f'{label}: only {moved} of {len(trainable)} parameters moved')
    state = model.state_dict()
    still = all(torch.equal(state[k], v) for k, v in start.items()
                if k.startswith(frozen))
    check(still, f'{label}: the frozen image branch changed')
    check(all(p.grad is None for n, p in model.named_parameters()
              if n.startswith(frozen)),
          f'{label}: a frozen image parameter has a gradient')
    print(f'{label}: {moved} of {len(trainable)} trainable tensors moved'
          + ('; the frozen image branch (weights and norm statistics) '
             'unchanged' if frozen else ''), flush=True)

    if spec['extras']:
        # the backward's dense convolutions on and off cuDNN (one step each)
        for on in (True, False, True):
            opt.zero_grad(set_to_none=True)
            preds = model(*inputs, generator=dropout_generator(
                inputs[0].device, SEED, 0))
            total = total_loss(model.loss(preds, *gt))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cudnn_enabled(on):
                total.backward()
                torch.cuda.synchronize()
            print(f'{label}: backward with cuDNN {"on" if on else "off"} '
                  f'{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock) '
                  f'[{card}]', flush=True)
            del preds, total

        def one_step():
            train_step(batch, spec['steps'] + 2)
        window_ms, busy_ms, ranked = profile_forward(one_step)
        check(busy_ms > 0, f'{label}: the profiler saw no device work')
        print(f'{label}: profile: one step {window_ms:.3f} ms host window, '
              f'device busy {busy_ms:.3f} ms, idle share '
              f'{1 - busy_ms / window_ms:.3f} [{card}]', flush=True)
        for ms, name in ranked:
            print(f'{label}: profile: {ms:9.3f} ms  {name[:100]}', flush=True)
    return recs, launches


# phase 8: the flagship under compute_dtype bfloat16 (the JAX package's
# MSMD_BF16, __graft_entry__.py:82, bench.py:128-133), on the calibrated
# weights: parameters cast as the JAX bench casts them (batch statistics
# stay fp32) under the packed engine (the JAX bench's setting) and under
# the one-hot engine, and fp32 parameters on the default x3 route. bf16
# features reach the sparse encoder's 21 convs and the GMA's 4 grouped
# convs; the GMA union on stays fp32 (flax's promotion), so the one-hot
# frame runs match_conv_bf16 on 25 calls and match_conv_x3 on 12
BF16 = (
    ('params cast, packed bf16', True, PACKED['env'],
     {'rows_affine': 16, 'gather_gemm_conv_bf16': 37, 'masked_nn': 8,
      'merge_take': 3}),
    ('params cast, one-hot', True, ONEHOT['env'],
     {'match_conv_bf16': 25, 'match_conv_x3': 12, 'masked_nn': 8,
      'merge_take': 3}),
    ('fp32 params, x3', False, {},
     {'rows_affine': 16, 'gather_gemm_conv_x3': 37, 'masked_nn': 8,
      'merge_take': 3}))
# phase 9: the JAX package's ablation and backend switches, one frame
# each on the default route; the exact nearest-voxel oracle searches all
# of a stage's 3D voxels once (4 masked_nn), the XLA backend launches no
# kernel
ABLATIONS = (
    ({'MSMD_GMA_NN': 'exact'}, dict(FLAGSHIP['launches'], masked_nn=4)),
    ({'MSMD_GMA_DUMMY': 'random:7'}, FLAGSHIP['launches']),
    ({'MSMD_FUSE_BN': '0'}, FLAGSHIP['launches']),
    ({'MSMD_SPARSE_BACKEND': 'xla'}, {}))


def voxel_features(model, inputs):
    """(the LiDAR voxel features the sparse encoder is handed, the
    predictions) of one forward."""
    import torch
    got = []
    hook = model.pts_middle_encoder.register_forward_pre_hook(
        lambda m, args: got.append(args[0].clone()))
    try:
        with torch.no_grad():
            preds = model(*inputs)
    finally:
        hook.remove()
    return got[0], preds


def determinism(model, inputs, card):
    """Two fp32 forwards of the default route: the voxel features must be
    bit-equal (the voxel mean's fixed-order segment sum); the dense
    heatmap's difference is printed."""
    import torch
    v1, p1 = voxel_features(model, inputs)
    v2, p2 = voxel_features(model, inputs)
    torch.cuda.synchronize()
    diff = float((p1['dense_heatmap'] - p2['dense_heatmap']).abs().max())
    print(f'MSMDFusion determinism: two forwards, voxel features bit-equal '
          f'{torch.equal(v1, v2)}; dense_heatmap max |difference| {diff:.3g}'
          f' ({diff / float(p1["dense_heatmap"].abs().max()):.3g} of max) '
          f'[{card}]', flush=True)
    check(torch.equal(v1, v2), 'determinism: the voxel features of two '
          'forwards differ')


def bf16_record(i, args, kwargs, reps, plain_reps, card):
    """One ``match_conv`` call on bf16 features (kernel
    ``match_conv_bf16``), with its epilogue and without, against the plain
    bf16 version: each element within one bf16 ulp of it plus TOL of the
    magnitude of its sum (the two passes' fp32 sums in another order:
    where a sum's terms cancel, its bf16 ulp is smaller than their
    rounding), at least ``BF16_EQUAL`` of them bit-equal to it
    (``bf16_equal``: the bound alone also holds a kernel that drops the
    ``W_lo`` pass), and timed. Returns its record."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    name = 'match_conv_bf16'
    feats, in_keys, plan, weights = args
    rows = mc.plan_rows_plain(in_keys, plan)
    k_out, ta = rows.shape
    cin, cout = weights.shape[1], weights.shape[2]
    magnitude = mc.gather_gemm_conv_plain(feats.float().abs(), rows,
                                          weights.float().abs())
    err, in_ulp, equal, worst = 0.0, 1.0, 1.0, 0.0
    for kw in (kwargs, {}):
        got = mc.match_conv(*args, **kw)
        want = mc.match_conv_plain(*args, **kw).float()
        mag = magnitude
        if kw.get('scale') is not None:
            mag = mag * kw['scale'].abs()
        if kw.get('shift') is not None:
            mag = mag + kw['shift'].abs()
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all()),
              f'{name} call {i}: {got.dtype} or non-finite output')
        diff = (got.float() - want).abs()
        ulp = bf16_ulp(want)
        limit = ulp + TOL * mag
        bad = int((diff > limit).sum())
        same, enough = bf16_equal(got.float(), want)
        check(enough, f'{name} call {i} ({cin}->{cout}, epilogue='
              f'{bool(kw)}): {same:.5f} of the elements bit-equal to the '
              f'plain version, below {BF16_EQUAL} ({bad} outside one bf16 '
              f'ulp and {TOL} of |sum|)')
        check(bad == 0, f'{name} call {i} ({cin}->{cout}, epilogue='
              f'{bool(kw)}): {bad} elements differ from the plain version '
              f'by more than one bf16 ulp and {TOL} of the magnitude of '
              'their sum')
        equal = min(equal, same)
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        in_ulp = min(in_ulp, float((diff <= ulp).float().mean())
                     if diff.numel() else 1.0)
        worst = max(worst, float((diff / limit).max()) if diff.numel()
                    else 0.0)
    hits = int((rows >= 0).sum())
    n_epi = sum(kwargs.get(k) is not None for k in ('scale', 'shift'))
    nbytes = (2 * feats.numel() + weights.element_size() * weights.numel()
              + 4 * n_epi * cout + 2 * k_out * cout
              + match_plan_bytes(in_keys, plan)
              + (k_out if kwargs.get('out_valid') is not None else 0))
    rec = dict(cin=cin, cout=cout, k_in=feats.shape[0], k_out=k_out, ta=ta,
               hits=hits, err=err, staged=block_staged_row_taps(rows),
               ms=cuda_ms(lambda: mc.match_conv(*args, **kwargs), reps),
               plain_ms=cuda_ms(lambda: mc.match_conv_plain(*args, **kwargs),
                                plain_reps),
               library_ms=None, bytes_ms=nbytes / PEAK_BYTES * 1e3,
               ops_ms=ops_ms(name, hits, cin, cout))
    print(f"{name}[{i}] {cin}->{cout} K_in={rec['k_in']} K_out={k_out} "
          f"Ta={ta} hits={hits} max_abs_err={err:.3g} bit-equal "
          f"{equal:.5f} (limit {BF16_EQUAL}), within one bf16 ulp "
          f"{in_ulp:.5f}, worst {worst:.3g} of the limit (1 ulp + {TOL} of "
          f"|sum|) ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
          f"bound_ms={max(rec['bytes_ms'], rec['ops_ms']):.4f} "
          f"useful={hits / max(rec['staged'], 1):.3f} [{card}]", flush=True)
    return rec


def bf16_calls(label, calls, card, reps=3, plain_reps=1):
    """Every recorded conv call of a bf16 frame whose features are bf16,
    on the kernel the switches pick, against its plain version.
    ``match_conv`` runs the bf16 kernel ``match_conv_bf16``, held by
    ``bf16_record``'s rule. ``gather_gemm_conv`` runs its fp32 kernel (x3
    or packed) on the features widened to fp32 and rounds the result once
    to bf16: the kernel's call is held to its plain versions as phases 4
    and 6 hold it (``conv_record``: each element within TOL of its sum's
    magnitude), and the wrapper's bf16 output must be that result rounded.
    Returns {kernel: records}."""
    import torch
    from msmdfusion_torch.ops.sparse import matchconv as mc
    out = {}
    for wrapper in ('gather_gemm_conv', 'match_conv'):
        for args, kwargs in calls[wrapper]:
            if args[0].dtype != torch.bfloat16:
                continue
            kwargs = dict(kwargs)
            if wrapper == 'match_conv':
                recs = out.setdefault(mc.match_kernel(torch.bfloat16), [])
                recs.append(bf16_record(len(recs), args, kwargs, reps,
                                        plain_reps, card))
                continue
            name = kernel_of(wrapper)
            recs = out.setdefault(name, [])
            i = len(recs)
            order = kwargs.pop('order', None)
            feats, rows, weights = args
            wide = (feats.float(), rows, weights.float())
            rec = conv_record(name, i, wide, kwargs, order, reps,
                              plain_reps)
            got = mc.gather_gemm_conv(*args, order=order, **kwargs)
            want = mc.gather_gemm_conv(*wide, order=order, **kwargs)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16 and torch.equal(
                got, want.to(torch.bfloat16)), f'{name} call {i}: the bf16 '
                'output is not the fp32 result rounded once')
            recs.append(rec)
            print(f"{name}[{i}] bf16 features {rec['cin']}->{rec['cout']} "
                  f"K_in={rec['k_in']} K_out={rec['k_out']} Ta={rec['ta']} "
                  f"hits={rec['hits']} max_abs_err={rec['err']:.3g} "
                  f"({rec['rel']:.3g} of max |ref|) worst |err|/|sum| "
                  f"{rec['elem']:.3g} (limit {TOL}) before the rounding, "
                  f"bf16 output the fp32 result rounded once ms="
                  f"{rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
                  f"bound_ms={max(rec['bytes_ms'], rec['ops_ms']):.4f} "
                  f"[{card}]", flush=True)
    for name, recs in out.items():
        staged = ('useful='
                  f"{sum(r['hits'] for r in recs) / max(sum(r['staged'] for r in recs), 1):.3f} "
                  if all('staged' in r for r in recs) else '')
        print(f"{label}: {name} sums over its {len(recs)} calls on "
              f"bf16 features: ms={sum(r['ms'] for r in recs):.3f} "
              f"plain_ms={sum(r['plain_ms'] for r in recs):.3f} bound_ms="
              f"{sum(max(r['bytes_ms'], r['ops_ms']) for r in recs):.3f} "
              f"{staged}[{card}]", flush=True)
    return out


def bf16_twin(label, model, inputs):
    """The bf16 frame's kernel path against its all-plain twin on the
    kernel path's proposals: every output, the head input and the dense
    heatmap too, within FLOOR_MARGIN times the plain path's own spread
    under reordered sums (never less than TOL): a conv's bf16 rounding
    turns the fp32 sums' order into bf16 steps, as phase 6's packed
    operands do, and no rounding is pinned here. Returns
    ``compare_outputs``' {key: (error over max |ref|, limit, ...)}."""
    import torch
    from msmdfusion_torch import kernels
    with torch.no_grad():
        run = pinned_forward(model, inputs, None)
        index = proposal_index(run)
        ref = pinned_forward(model, inputs, index, kernels.plain_kernels(),
                             X3Plain())
        alt = pinned_forward(model, inputs, index, kernels.plain_kernels(),
                             X3Plain(), ReorderedSums())
        worst = compare_outputs(run, ref, alt, at_tol=())
        del run, ref, alt
    for key, (rel, limit, floor, median) in worst.items():
        held = 'not held' if key == 'yaw' else f'limit {limit:.3g}'
        print(f'{label}: kernel vs plain path: {key} {rel:.3g} of max |ref| '
              f'({held}; plain path with reordered sums {floor:.3g}; median '
              f'|ref| {median:.3g})', flush=True)
    return worst


def bf16_frame(label, model, inputs, card, expected, fp32):
    """One bf16 frame (the module docstring's phase 8): each bf16-feature
    conv call held to its plain version, the launches of a counted frame
    held to ``expected``, no row dropped, the sparse encoder's output
    bf16 and the predictions and boxes fp32 and finite, the twin, how far
    its head input and boxes lie from the fp32 path's (``fp32``, printed),
    ms/frame, stages and a profile. Returns (records, launches)."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.utils import overflow, timing
    with torch.no_grad(), Recorder() as rec:
        forward(model, inputs)
    torch.cuda.synchronize()
    recs = bf16_calls(label, rec.calls, card)
    del rec
    seen = []
    hook = model.pts_middle_encoder.register_forward_hook(
        lambda m, a, o: seen.append(o[0].dtype))
    try:
        with torch.no_grad():
            kernels.reset_launches()
            with overflow.capture() as cap, timing.record('cuda') as tr:
                preds, boxes = forward(model, inputs)
            launches = dict(kernels.launches)
            torch.cuda.synchronize()
    finally:
        hook.remove()
    print(f'{label}: launches on the main path: {launches}', flush=True)
    check_launches(label, launches, expected)
    check(cap.total() == 0, f'{label}: overflow {cap.counters()}')
    check(seen == [torch.bfloat16], f'{label}: sparse encoder output {seen}')
    floats = [v for v in list(preds.values()) + list(boxes.values())
              if v.is_floating_point()]
    check(all(v.dtype == torch.float32 for v in floats),
          f'{label}: predictions or boxes not fp32')
    check(bool(torch.isfinite(boxes['bboxes']).all()),
          f'{label}: non-finite boxes')
    s = boxes['scores']
    check(bool(((s >= 0) & (s <= 1)).all()), f'{label}: scores outside '
          '[0, 1]')
    print(f'{label}: overflow_total 0; sparse encoder output bf16, '
          'predictions and boxes fp32', flush=True)
    stage_ms = {k: round(v, 4) for k, v in tr.ms().items()}
    print(f'{label}: stage_ms {json.dumps(stage_ms)} [{card}]', flush=True)
    bf16_twin(label, model, inputs)
    path_vs(f'{label} vs the fp32 (x3) path [{card}]', model, inputs, fp32)
    with torch.no_grad():
        frame_ms = cuda_ms(lambda: forward(model, inputs), 5)
        window_ms, busy_ms, ranked = profile_forward(
            lambda: forward(model, inputs))
    print(f'{label}: e2e {frame_ms:.3f} ms/frame (CUDA events, 5 frames), '
          f'{1e3 / frame_ms:.2f} frames/s; profile: one forward '
          f'{window_ms:.3f} ms host window, device busy {busy_ms:.3f} ms, '
          f'idle share {1 - busy_ms / window_ms:.3f} [{card}]', flush=True)
    for ms, name in ranked[:4]:
        print(f'{label}: profile: {ms:9.3f} ms  {name[:100]}', flush=True)
    return recs, launches


def bf16_frames(model, inputs, card, fp32, build=build_flagship):
    """Phase 8 on the calibrated weights of ``model``: each of ``BF16``'s
    frames on a bf16-compute flagship (``build(device,
    compute_dtype='bfloat16')``) loaded with them (parameters cast by
    ``layers.cast_params`` where the frame says: every parameter bf16, the
    running statistics fp32). ``fp32``: the fp32 path's
    ``path_outputs``. Returns [(records, launches)]."""
    import torch
    from msmdfusion_torch.models.layers import cast_params
    dev = next(model.parameters()).device
    calibrated = model.state_dict()
    out = []
    for name, cast, env, expected in BF16:
        bf16 = build(dev, compute_dtype='bfloat16')
        bf16.load_state_dict(calibrated)
        if cast:
            cast_params(bf16)
            check({p.dtype for p in bf16.parameters()} == {torch.bfloat16}
                  and {b.dtype for n, b in bf16.named_buffers()
                       if 'running' in n} == {torch.float32},
                  'cast_params: parameters bf16, statistics fp32')
        label = f'MSMDFusion bf16, {name}'
        with switches(env):
            print(f'{label}: {env}', flush=True)
            out.append(bf16_frame(label, bf16, inputs, card, expected, fp32))
        del bf16
        torch.cuda.empty_cache()
    return out


def ablation_frames(model, inputs, card):
    """Phase 9 (``ABLATIONS``), each switch set around its frame only: the
    launches of a counted frame, no row dropped, finite boxes, ms/frame.
    Under ``MSMD_GMA_NN=exact`` every ``masked_nn`` call (a stage's camera
    voxels against all its LiDAR voxels) is held bit-equal to its plain
    version and timed; under ``MSMD_FUSE_BN=0`` the head input lies within
    TOL of the fused frame's largest value. Returns [(records,
    launches)] of the exact frame's ``masked_nn``."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.utils import overflow
    with torch.no_grad(), HeadInput(model.pts_bbox_head) as fused:
        forward(model, inputs)
    out = []
    for env, expected in ABLATIONS:
        label = f'MSMDFusion {" ".join(f"{k}={v}" for k, v in env.items())}'
        with switches(env), torch.no_grad():
            if 'MSMD_GMA_NN' in env:
                with Recorder() as rec:
                    forward(model, inputs)
                recs = nn_calls(rec.calls['masked_nn'], 3, card,
                                plain_reps=1)
                del rec
                print(f"{label}: masked_nn sums over the frame's "
                      f"{len(recs)} calls: ms={sum(r['ms'] for r in recs):.3f}"
                      f" plain_ms={sum(r['plain_ms'] for r in recs):.3f} "
                      f"bound_ms="
                      f"{sum(max(r['bytes_ms'], r['ops_ms']) for r in recs):.4f}"
                      f" [{card}]", flush=True)
            kernels.reset_launches()
            with overflow.capture() as cap, \
                    HeadInput(model.pts_bbox_head) as head_in:
                preds, boxes = forward(model, inputs)
            launches = dict(kernels.launches)
            torch.cuda.synchronize()
            print(f'{label}: launches on the main path: {launches}',
                  flush=True)
            check_launches(label, launches, expected)
            check(cap.total() == 0, f'{label}: overflow {cap.counters()}')
            check(bool(torch.isfinite(boxes['bboxes']).all()),
                  f'{label}: non-finite boxes')
            err, rel = rel_err(head_in.x, fused.x)
            if 'MSMD_FUSE_BN' in env:
                check(rel <= TOL, f'{label}: head input {rel:.3g} of max '
                      f'from the fused frame, above {TOL}')
            frame_ms = cuda_ms(lambda: forward(model, inputs), 3)
        print(f'{label}: head input {err:.4g} ({rel:.4g} of max) from the '
              f'default frame{" (limit %g)" % TOL if "MSMD_FUSE_BN" in env else ""}; '
              f'overflow_total 0; e2e {frame_ms:.3f} ms/frame (CUDA events, '
              f'3 frames) [{card}]', flush=True)
        if 'MSMD_GMA_NN' in env:
            out.append(({'masked_nn': recs}, launches))
    return out


def image_train_step(model, inputs, gt, card, steps=3):
    """Phase 10: the flagship's train step with the image branch trained
    (``freeze_img=False``): every parameter in the optimizer, as the JAX
    package's optax chain takes them with no frozen predicate; the
    ResNet's norms on their running statistics (``norm_eval``). One
    counted step (the launches of phase 5's step), then ``steps`` timed
    steps (CUDA events); finite losses, the image parameters moved, the
    ResNet's statistics unchanged, peak memory. The model's state is
    restored after."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.train import (build_lr_schedule,
                                             build_optimizer,
                                             make_train_step)
    from msmdfusion_torch.utils import overflow
    label = 'MSMDFusion image-branch train'
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.freeze_img = False
    try:
        schedule = build_lr_schedule(TRAIN['lr_config'],
                                     TRAIN['optimizer']['lr'],
                                     TRAIN['total_steps'],
                                     TRAIN['steps_per_epoch'])
        opt = build_optimizer(model, TRAIN['optimizer'],
                              TRAIN['optimizer_config'], schedule)
        n_opt = sum(len(g['params']) for g in opt.param_groups)
        check(n_opt == len(list(model.parameters())),
              f'{label}: {n_opt} parameters in the optimizer')
        step = make_train_step(model, opt, seed=SEED)
        batch = dict(inputs=inputs, gt_bboxes=gt[0], gt_labels=gt[1],
                     gt_valid=gt[2])
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with overflow.capture() as cap:
            metrics = step(batch, 0)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
        print(f'{label}: launches of one step: {launches}', flush=True)
        check_launches(label, launches, TRAIN['launches'])
        check(cap.total() == 0, f'{label}: overflow {cap.counters()}')
        times = []
        for i in range(1, steps + 1):
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            metrics = step(batch, i)
            end.record()
            torch.cuda.synchronize()
            times.append(begin.elapsed_time(end))
            check(bool(torch.isfinite(metrics['total_loss'])),
                  f'{label}: step {i} loss {metrics["total_loss"]}')
        sd = model.state_dict()
        stats = [k for k in start if k.startswith('img_backbone.')
                 and k.endswith(('running_mean', 'running_var'))]
        check(stats and all(torch.equal(sd[k], start[k]) for k in stats),
              f'{label}: the ResNet\'s batch-norm statistics moved')
        weights = [k for k, _ in model.named_parameters()
                   if k.startswith(('img_backbone.', 'img_neck.'))]
        moved = sum(not torch.equal(sd[k], start[k]) for k in weights)
        check(moved > len(weights) // 2,
              f'{label}: {moved} of {len(weights)} image parameters moved')
        print(f'{label}: {steps} steps {sum(times) / steps:.3f} ms/step mean '
              f'(CUDA events; {", ".join(f"{t:.1f}" for t in times)}), total '
              f'loss {float(metrics["total_loss"]):.5g}; {moved} of '
              f'{len(weights)} image parameters moved, the ResNet\'s '
              f'{len(stats)} statistics unchanged; peak memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB '
              f'[{card}]', flush=True)
    finally:
        model.freeze_img = True
        model.load_state_dict(start)
        model.eval()
    return launches



def tl_train_step(model, inputs, gt, card):
    """Phase 11: TransFusion-L's stage-1 step on phase 3's calibrated model
    and frame with its config's recipe (``TL_TRAIN``): phase 5's path
    (``drive_train``: every ``rows_queries``, backward conv and ``conv_dw``
    call held to its plain versions, the all-plain twin to phase 5's
    limits, a counted step, timed steps). Training takes the config's
    train-time voxel capacity, as the JAX package does, below the frame's
    voxels: the counted step must drop exactly the difference at
    ``voxelize.mean_batch.voxel_cap`` and nothing anywhere else."""
    import torch
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.utils import overflow
    cfg = load_config(str(TL['config']))
    train_cap = cfg.model.pts_voxel_layer.max_voxels[0]
    model.eval()
    with torch.no_grad(), overflow.capture() as cap:
        model(*inputs)
    n_voxels = max(cap.gauge_values()['occ.voxelize_mean'])
    check(n_voxels > train_cap, f'the frame has {n_voxels} voxels, not more '
          f'than the train-time capacity {train_cap}')
    model.pts_voxel_layer['max_voxels'] = (train_cap, TL['max_voxels'])
    recipe = dict(optimizer=dict(cfg.optimizer),
                  optimizer_config=dict(cfg.optimizer_config),
                  lr_config=dict(cfg.lr_config),
                  total_steps=cfg.total_epochs * TL_STEPS_PER_EPOCH,
                  steps_per_epoch=TL_STEPS_PER_EPOCH, frozen=())
    print(f'TransFusion-L train: {recipe}; the frame\'s {n_voxels} voxels '
          f'over the train-time capacity {train_cap}: '
          f'{n_voxels - train_cap} dropped by the configured cap', flush=True)
    spec = dict(TL_TRAIN, overflow={'voxelize.mean_batch.voxel_cap':
                                    n_voxels - train_cap})
    try:
        return drive_train(model, inputs, gt, card, spec,
                           label='TransFusion-L train', recipe=recipe)
    finally:
        model.pts_voxel_layer['max_voxels'] = (TL['max_voxels'],) * 2
        model.eval()


def split_steps(label, step, model, opt, batch, steps, card, restore=None):
    """``steps`` calls of a ``make_train_step`` step, each split by CUDA
    events at its seams (phase 5's split, on the main path itself): the
    model's forward (its hooks), the loss with the assignment (``model.loss``
    wrapped), the backward (to the optimizer's step) and the optimizer
    (``opt.step`` wrapped); finite losses; the mean split printed.
    ``restore``: a state dict loaded before each step, outside its
    seams."""
    import torch
    marks = {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()
    loss, opt_step = model.loss, opt.step

    def timed_loss(*args, **kwargs):
        out = loss(*args, **kwargs)
        mark('loss')
        return out

    def timed_step(*args, **kwargs):
        mark('backward')
        out = opt_step(*args, **kwargs)
        mark('optimizer')
        return out
    hooks = [model.register_forward_pre_hook(lambda m, a: mark('start')),
             model.register_forward_hook(lambda m, a, o: mark('forward'))]
    model.loss, opt.step = timed_loss, timed_step
    split = []
    try:
        for i in range(1, steps + 1):
            if restore is not None:
                model.load_state_dict(restore)
            metrics = step(batch, i)
            torch.cuda.synchronize()
            names = ('start', 'forward', 'loss', 'backward', 'optimizer')
            split.append([marks[a].elapsed_time(marks[b])
                          for a, b in zip(names, names[1:])])
            check(bool(torch.isfinite(metrics['total_loss'])),
                  f'{label}: step {i} loss {metrics["total_loss"]}')
    finally:
        for h in hooks:
            h.remove()
        del model.loss, opt.step
    fwd, lss, bwd, upd = (sum(s[i] for s in split) / steps for i in range(4))
    print(f'{label}: step {fwd + lss + bwd + upd:.3f} ms = forward {fwd:.3f} '
          f'+ loss with the assignment {lss:.3f} + backward {bwd:.3f} + '
          f'optimizer {upd:.3f} (CUDA events at the seams of make_train_step,'
          f' mean of {steps} steps; totals '
          f'{", ".join(f"{sum(s):.1f}" for s in split)}) [{card}]',
          flush=True)
    return split


def stage2_train_step(model, inputs, gt, card, steps=STAGE2_STEPS):
    """Phase 12: the flagship's stage-2 step as its config states it:
    ``freeze_img`` and ``freeze_lidar_components`` (``apis.train.
    frozen_prefixes``), phase 5's optimizer and schedule. One counted step
    (phase 5's launches: the frozen encoder still runs its backward, whose
    gradients count in ``grad_norm`` and not in the clip's norm), then
    ``steps`` timed steps; the frozen modules' parameters and statistics
    bit-equal afterwards (their norms took the batch's moments), the
    other parameters and statistics moved; ``grad_norm`` the hypotenuse of
    the clip's norm and the frozen gradients' norm. The model's state is restored
    after. Returns the counted step's launches."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.train import (FROZEN_IMG_PREFIXES,
                                             FROZEN_LIDAR_PREFIXES,
                                             build_lr_schedule,
                                             build_optimizer,
                                             frozen_prefixes, global_norm,
                                             make_train_step)
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.utils import overflow
    label = 'MSMDFusion stage-2 train'
    frozen = frozen_prefixes(load_config(str(FLAGSHIP['config'])))
    check(frozen == FROZEN_LIDAR_PREFIXES + FROZEN_IMG_PREFIXES,
          f'{label}: the config freezes {frozen}')
    under = tuple(f + '.' for f in frozen)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    try:
        schedule = build_lr_schedule(TRAIN['lr_config'],
                                     TRAIN['optimizer']['lr'],
                                     TRAIN['total_steps'],
                                     TRAIN['steps_per_epoch'])
        opt = build_optimizer(model, TRAIN['optimizer'],
                              TRAIN['optimizer_config'], schedule,
                              frozen_prefixes=frozen)
        trainable = optimized(model, opt)
        names = [n for n, _ in trainable]
        check(not any(n.startswith(under) for n in names)
              and any(n.startswith('multimodal_middle_encoder.')
                      for n in names),
              f'{label}: the optimizer holds a frozen parameter or no GMA '
              'parameter')
        step = make_train_step(model, opt, seed=SEED)
        batch = dict(inputs=inputs, gt_bboxes=gt[0], gt_labels=gt[1],
                     gt_valid=gt[2])
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with overflow.capture() as cap:
            metrics = step(batch, 0)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
        print(f'{label}: frozen {frozen}; launches of one step: {launches}',
              flush=True)
        check_launches(label, launches, TRAIN['launches'])
        check(cap.total() == 0, f'{label}: overflow {cap.counters()}')
        # the metric over every gradient, the clip's over the trainable
        # ones: metric^2 = clip^2 + the frozen modules' norm^2
        grad_norm = float(metrics['grad_norm'])
        clip_norm = float(opt.grad_norm())
        frozen_norm = float(global_norm(
            p.grad for n, p in model.named_parameters() if n.startswith(under)))
        lidar = float(global_norm(p.grad for n, p in model.named_parameters()
                                  if n.startswith('pts_middle_encoder.')))
        check(lidar > 0 and abs(grad_norm - math.hypot(clip_norm, frozen_norm))
              <= TOL * grad_norm,
              f'{label}: grad_norm {grad_norm}, trainable {clip_norm}, '
              f'frozen {frozen_norm} (the LiDAR encoder {lidar})')
        split_steps(label, step, model, opt, batch, steps, card)
        sd = model.state_dict()
        kept = [k for k in start if k.startswith(under)]
        stats = [k for k in kept if k.startswith('pts_middle_encoder.')
                 and k.endswith(('running_mean', 'running_var'))]
        check(stats and all(torch.equal(sd[k], start[k]) for k in kept),
              f'{label}: a frozen parameter or statistic changed')
        moved = sum(not torch.equal(p, start[n]) for n, p in trainable)
        check(moved >= 0.9 * len(trainable),
              f'{label}: only {moved} of {len(trainable)} parameters moved')
        other = [k for k in start if not k.startswith(under)
                 and k.endswith('running_mean')]
        moved_stats = sum(not torch.equal(sd[k], start[k]) for k in other)
        check(moved_stats > 0, f'{label}: no trainable norm statistic moved')
        print(f'{label}: step 0 grad_norm {grad_norm:.6f} over every '
              f'gradient, the clip\'s over the trainable ones '
              f'{clip_norm:.6f}, the frozen modules\' {frozen_norm:.6f} (the '
              f'LiDAR encoder\'s {lidar:.6f}); '
              f'{len(kept)} frozen tensors ({len(stats)} LiDAR-encoder '
              f'statistics) bit-equal after {steps + 1} steps, {moved} of '
              f'{len(trainable)} trainable tensors and {moved_stats} of '
              f'{len(other)} trainable norms\' means moved; peak memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB '
              f'[{card}]', flush=True)
    finally:
        model.load_state_dict(start)
        model.eval()
    return launches


def bf16_train_step(label, model, inputs, gt, card, expected,
                    steps=BF16_TRAIN_STEPS):
    """One engine of phase 13 on a bf16-compute flagship with fp32
    parameters (phase 5's recipe): one step's backward conv calls on bf16
    cotangents held to their plain versions by phase 8's rules
    (``bf16_calls``: ``match_conv_bf16``'s ``d_feats`` over the dual plans
    by the bf16 rule, the rulebook calls on widened rows as fp32 kernel
    calls rounded once) and its ``conv_dw`` calls on bf16 operands as fp32
    calls on the widened ones; the all-plain twin on the kernel path's
    proposals, assignment, dropout, head-input gradient, ReLU masks and
    conv operands (``PinnedRounding``: the packed engine's bf16 rounding
    and the x3 split of the fp32 convs from the GMA union on), every loss
    and gradient within FLOOR_MARGIN times the plain path's own spread,
    never less than TOL; one counted step through
    ``make_train_step`` (launches ``expected``, the backward's apart, no
    row dropped, the encoder's output bf16, every gradient and parameter
    fp32), ``steps`` timed steps. Returns ({'match_conv_bf16 d_feats':
    records} where the engine runs it, launches with the backward's
    ``match_conv_bf16`` under that name)."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.train import (build_lr_schedule,
                                             build_optimizer,
                                             make_train_step)
    from msmdfusion_torch.utils import overflow
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def restore_buffers():
        with torch.no_grad():
            for name, b in model.named_buffers():
                b.copy_(start[name])
    schedule = build_lr_schedule(TRAIN['lr_config'], TRAIN['optimizer']['lr'],
                                 TRAIN['total_steps'],
                                 TRAIN['steps_per_epoch'])
    opt = build_optimizer(model, TRAIN['optimizer'],
                          TRAIN['optimizer_config'], schedule,
                          frozen_prefixes=TRAIN['frozen'])
    model.train()
    relu = ReluMasks()
    pins = PinnedRounding()
    with Recorder() as rec:
        run = train_pass(model, inputs, gt, rec=rec, scopes=[relu, pins])
    restore_buffers()
    bf16 = torch.bfloat16
    backward = {w: [c for c in rec.calls_in(w, 'backward')
                    if c[0][0].dtype == bf16]
                for w in ('gather_gemm_conv', 'match_conv')}
    dws = [((args[0].float(), args[1], args[2].float()), kwargs)
           for args, kwargs in rec.calls['conv_dw']
           if args[0].dtype == bf16 and args[2].dtype == bf16]
    n_bwd = sum(len(v) for v in backward.values())
    check(n_bwd == 24 and len(dws) == 25,
          f'{label}: {n_bwd} backward convs and {len(dws)} dw on bf16 rows, '
          'expected 24 and 25')
    with torch.no_grad():
        recs = bf16_calls(f'{label} backward', backward, card, reps=3,
                          plain_reps=1)
        dw_recs = dw_calls(dws, 2, card, plain_reps=1)
    del rec
    print(f'{label}: {kernel_of("conv_dw")} sums over the step\'s '
          f'{len(dw_recs)} dw calls on bf16 operands (widened): '
          f'ms={sum(r["ms"] for r in dw_recs):.3f} '
          f'plain_ms={sum(r["plain_ms"] for r in dw_recs):.3f} [{card}]',
          flush=True)

    pinned = dict(targets=run['targets'], index=run['index'],
                  head_grad=run['head_grad'])
    ref = train_pass(model, inputs, gt, scopes=[
        kernels.plain_kernels(), X3Plain(), ReluMasks(relu.masks),
        pins.replay()], **pinned)
    restore_buffers()
    alt = train_pass(model, inputs, gt, scopes=[
        kernels.plain_kernels(), X3Plain(), ReorderedSums(),
        ReluMasks(relu.masks), pins.replay()], **pinned)
    restore_buffers()
    rows = compare_train(run, ref, alt, spread_only=True)
    for rel, limit, floor, name in rows[:6]:
        print(f'{label}: kernel vs plain path: {name} {rel:.3g} of max |ref| '
              f'(limit {limit:.3g}; reordered plain path {floor:.3g})',
              flush=True)
    bad = [r for r in rows if r[0] > r[1]]
    check(not bad, f'{label}: kernel vs plain path above the limit: '
          f'{bad[:5]}')
    del run, ref, alt, relu, pins

    batch = dict(inputs=inputs, gt_bboxes=gt[0], gt_labels=gt[1],
                 gt_valid=gt[2])
    step = make_train_step(model, opt, seed=SEED)
    forward_launches, seen = {}, []
    hooks = [model.register_forward_hook(
                 lambda m, a, o: forward_launches.update(kernels.launches)),
             model.pts_middle_encoder.register_forward_hook(
                 lambda m, a, o: seen.append(o[0].dtype))]
    kernels.reset_launches()
    try:
        with overflow.capture() as cap:
            metrics = step(batch, 0)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    in_backward = {k: v - forward_launches.get(k, 0)
                   for k, v in launches.items()}
    print(f'{label}: launches of one step: {launches} (the backward\'s '
          f'{in_backward})', flush=True)
    check_launches(label, launches, expected)
    check(cap.total() == 0, f'{label}: overflow {cap.counters()}')
    check(seen == [bf16], f'{label}: sparse encoder output {seen}')
    check(all(p.dtype == torch.float32 and (p.grad is None
                                            or p.grad.dtype == torch.float32)
              for p in model.parameters()),
          f'{label}: a parameter or gradient is not fp32')
    check(bool(torch.isfinite(metrics['total_loss'])),
          f'{label}: non-finite loss')
    print(f'{label}: overflow_total 0; encoder output bf16, gradients and '
          'parameters fp32', flush=True)
    split_steps(label, step, model, opt, batch, steps, card)
    name = 'match_conv_bf16'
    if name not in recs:
        return {}, launches
    check(in_backward.get(name) == len(recs[name]),
          f'{label}: {in_backward.get(name)} backward {name} launches, '
          f'{len(recs[name])} calls held')
    return ({f'{name} d_feats': recs[name]},
            {f'{name} d_feats': in_backward[name]})


def bf16_train_steps(model, inputs, gt, card, build=build_flagship):
    """Phase 13 on the calibrated weights of ``model``: ``BF16_TRAIN``'s
    engines, each on a bf16-compute flagship (``build(device,
    compute_dtype='bfloat16')``, fp32 parameters) loaded with them, the
    engine's switches set around it only (``bf16_train_step``). Returns
    [(records, launches)]."""
    import torch
    dev = next(model.parameters()).device
    calibrated = model.state_dict()
    out = []
    for name, env, expected in BF16_TRAIN:
        bf16 = build(dev, compute_dtype='bfloat16')
        bf16.load_state_dict(calibrated)
        label = f'MSMDFusion bf16 train, fp32 params, {name}'
        with switches(env):
            print(f'{label}: {env}', flush=True)
            out.append(bf16_train_step(label, bf16, inputs, gt, card,
                                       expected))
        del bf16
        torch.cuda.empty_cache()
    return out


def keep_tl(model, inputs):
    """Phase 3's calibrated TransFusion-L weights, its frame and its
    outputs on it, for phase 14 (phase 11 trains the model)."""
    import torch
    with torch.no_grad():
        preds, boxes = forward(model, inputs)
    return dict(state={k: v.detach().clone()
                       for k, v in model.state_dict().items()},
                inputs=inputs, preds=dict(preds, **boxes))


def lc_model(device, config, lidar_state, inputs, caps=TL['enc_caps'],
             max_voxels=TL['max_voxels']):
    """A TransFusion-LC model at full width on a TransFusion-L's LiDAR
    weights (``lidar_state``): the image branch and the head's image
    fusion drawn from the seed, their norms calibrated on ``inputs``
    (``calibrate_norms``), then the LiDAR weights and statistics loaded
    over every module the two models share."""
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    model = build_model(device, config=config, n_caps=caps,
                        max_voxels=max_voxels)
    calibrate_norms(model, *inputs)
    missing, unexpected = model.load_state_dict(lidar_state, strict=False)
    head = model.pts_bbox_head
    nl = head.num_decoder_layers
    image = ('img_backbone.', 'img_neck.') + tuple(
        f'pts_bbox_head.{m}.' for m in
        ['shared_conv_img', 'heatmap_head_img', 'fc', f'prediction_heads.{nl}']
        + [f'decoder.{i}' for i in range(nl, len(head.decoder))])
    check(not unexpected and missing
          and all(k.startswith(image) for k in missing),
          f'{config.name}: keys the LiDAR model lacks {missing[:4]}, keys it '
          f'has that the LC model lacks {unexpected[:4]}')
    return model


def without_images(label, model, inputs, ref):
    """The LC model called without images is TransFusion-L: its outputs
    on the LiDAR inputs against ``ref`` (a TransFusion-L's on the same
    weights), every key within TOL of its largest value (the same
    computation: 0 expected, printed)."""
    import torch
    with torch.no_grad():
        preds, boxes = forward(model, inputs[:2])
    out = dict(preds, **boxes)
    check(set(out) == set(ref) and 'on_the_image' not in out,
          f'{label}: keys {sorted(set(out) ^ set(ref))} differ from '
          'TransFusion-L\'s')
    worst = 0.0
    for key, want in ref.items():
        if want.dtype in (torch.bool, torch.int64, torch.int32):
            check(torch.equal(out[key], want), f'{label}: {key} differ '
                  'from TransFusion-L\'s')
            continue
        rel = rel_err(out[key], want)[1]
        check(rel <= TOL, f'{label}: {key} {rel:.3g} of max from '
              'TransFusion-L\'s')
        worst = max(worst, rel)
    print(f'{label}: called without images, TransFusion-L\'s outputs on '
          f'the same weights: largest difference {worst:.3g} of max',
          flush=True)


def image_stages(label, model, inputs, card):
    """The share of proposals on an image and the image stages' ms of one
    forward (CUDA events)."""
    import torch
    from msmdfusion_torch.utils import timing
    with torch.no_grad(), timing.record('cuda') as tr:
        preds = model(*inputs)
    on = preds['on_the_image']
    stages = {k: round(v, 4) for k, v in tr.ms().items()}
    print(f'{label}: {int(on.sum())} of {on.numel()} proposals on an image '
          f'(share {float(on.float().mean()):.3f}); image branch '
          f'{stages["img"]:.3f} ms, image-to-BEV {stages["img_bev"]:.3f} ms, '
          f'the proposals\' image refinement {stages["img_fusion"]:.3f} ms, '
          f'head {stages["head"]:.3f} ms [{card}]', flush=True)
    return float(on.float().mean())


def lc_inference(tl, card):
    """Phase 14: TransFusion-LC inference at full width on phase 3's
    weights and frame with six cameras: the LC model without images gives
    phase 3's outputs; the path (``drive``: every kernel call against its
    plain version, launches 8/21, no row dropped, the twin to phase 3's
    limits); the share of proposals on an image and the image stages' ms.
    Returns (model, inputs, ground truth)."""
    label = 'TransFusion-LC'
    dev = tl['inputs'][0].device
    inputs, gt = make_lc_scene(LC['config'], LC['dataset'], TL['n_points'],
                               LC['img_hw'], dev)
    check(all(a.equal(b) for a, b in zip(inputs[:2], tl['inputs'])),
          f'{label}: the frame\'s points are not phase 3\'s')
    model = lc_model(dev, LC['config'], tl['state'], inputs)
    without_images(label, model, inputs, tl['preds'])
    lc_dense_engines(model, inputs, card)
    drive(label, model, inputs, LC, card, reps=dict(kernel=4, frame=5))
    image_stages(label, model, inputs, card)
    return model, inputs, gt


def lc_train_step(model, inputs, gt, card, steps=LC_TRAIN_STEPS):
    """Phase 15: TransFusion-LC's step under ``freeze_img`` with its
    config's recipe (phase 11's: AdamW, clip 0.1, the cyclic schedule, the
    train-time voxel capacity, whose drop alone is expected). One counted
    step (phase 11's launches), then ``steps`` timed steps: the image
    branch's parameters and statistics bit-equal after, its norms in eval
    mode throughout, its gradients nonzero and counted in ``grad_norm``
    (the JAX detector stops none: metric^2 = the clip's norm^2 + theirs^2),
    the trainable parameters moved."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.train import (FROZEN_IMG_PREFIXES,
                                             build_lr_schedule,
                                             build_optimizer,
                                             frozen_prefixes, global_norm,
                                             make_train_step)
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.utils import overflow
    label = 'TransFusion-LC train'
    cfg = load_config(str(LC['config']))
    frozen = frozen_prefixes(cfg)
    check(frozen == FROZEN_IMG_PREFIXES, f'{label}: the config freezes '
          f'{frozen}')
    under = tuple(f + '.' for f in frozen)
    train_cap = cfg.model.pts_voxel_layer.max_voxels[0]
    model.eval()
    with torch.no_grad(), overflow.capture() as cap:
        model(*inputs)
    n_voxels = max(cap.gauge_values()['occ.voxelize_mean'])
    check(n_voxels > train_cap, f'{label}: {n_voxels} voxels, not more than '
          f'the train-time capacity {train_cap}')
    model.pts_voxel_layer['max_voxels'] = (train_cap, TL['max_voxels'])
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 cfg.total_epochs * TL_STEPS_PER_EPOCH,
                                 TL_STEPS_PER_EPOCH)
    opt = build_optimizer(model, dict(cfg.optimizer),
                          dict(cfg.optimizer_config), schedule,
                          frozen_prefixes=frozen)
    trainable = optimized(model, opt)
    check(trainable and not any(n.startswith(under) for n, _ in trainable),
          f'{label}: the optimizer holds a frozen parameter')
    modes = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: modes.append(m.training))
        for n, m in model.named_modules() if n.startswith(under)
        and isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, opt, seed=SEED)
    batch = dict(inputs=inputs, gt_bboxes=gt[0], gt_labels=gt[1],
                 gt_valid=gt[2])
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with overflow.capture() as cap:
            metrics = step(batch, 0)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
        print(f'{label}: frozen {frozen}; launches of one step: {launches}',
              flush=True)
        check_launches(label, launches, TL_TRAIN['launches'])
        dropped = {k: v for k, v in cap.counters().items() if v}
        want = {'voxelize.mean_batch.voxel_cap': n_voxels - train_cap}
        check(dropped == want, f'{label}: overflow {dropped}, expected {want}')
        grads = {n: p.grad for n, p in model.named_parameters()}
        img = [n for n in grads if n.startswith(under)]
        with_grad = [n for n in img if grads[n] is not None
                     and bool(grads[n].abs().max() > 0)]
        grad_norm = float(metrics['grad_norm'])
        clip_norm = float(opt.grad_norm())
        img_norm = float(global_norm(grads[n] for n in img))
        check(len(with_grad) > len(img) // 2 and abs(
            grad_norm - math.hypot(clip_norm, img_norm)) <= TOL * grad_norm,
              f'{label}: grad_norm {grad_norm}, trainable {clip_norm}, the '
              f'image branch {img_norm} ({len(with_grad)} of {len(img)} '
              'image parameters with a gradient)')
        split_steps(label, step, model, opt, batch, steps, card)
        check(modes and not any(modes), f'{label}: an image-branch norm ran '
              'in training mode')
        sd = model.state_dict()
        kept = [k for k in start if k.startswith(under)]
        check(all(torch.equal(sd[k], start[k]) for k in kept),
              f'{label}: a frozen image parameter or statistic changed')
        moved = sum(not torch.equal(p, start[n]) for n, p in trainable)
        check(moved >= 0.9 * len(trainable),
              f'{label}: only {moved} of {len(trainable)} parameters moved')
        print(f'{label}: step 0 total_loss '
              f'{float(metrics["total_loss"]):.6f}, {n_voxels - train_cap} '
              f'voxels dropped by the configured cap; grad_norm '
              f'{grad_norm:.6f} over every gradient, the clip\'s '
              f'{clip_norm:.6f}, the frozen image branch\'s {img_norm:.6f} '
              f'({len(with_grad)} of {len(img)} image parameters with a '
              f'gradient: the FPN levels above 0 feed nothing); {len(kept)} '
              f'image tensors bit-equal and its {len(modes)} norm calls in '
              f'eval mode over {steps + 1} steps; {moved} of '
              f'{len(trainable)} trainable tensors moved; peak memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB '
              f'[{card}]', flush=True)
    finally:
        for h in hooks:
            h.remove()
        model.pts_voxel_layer['max_voxels'] = (TL['max_voxels'],) * 2
        model.eval()
    return launches


def probe_caps(device, inputs):
    """The Waymo encoder's strided-output occupancy on ``inputs`` (one
    eval forward with every capacity at four times the voxel capacity):
    ({site: rows}, the frame's voxels)."""
    import torch
    from msmdfusion_torch.utils import overflow
    probe = build_model(device, config=WAYMO['config'], n_caps=[4 * max(
        WAYMO['enc_caps'])] * len(ENC_SITES))
    with torch.no_grad(), overflow.capture() as cap:
        probe(*inputs[:2])
    occ = cap.gauge_values()
    dropped = {k: v for k, v in cap.counters().items() if v
               and k != 'voxelize.mean_batch.voxel_cap'}
    check(not dropped, f'Waymo probe: overflow {dropped}')
    return ({site: max(occ[f'occ.downsample_out[{site}]'])
             for site in ENC_SITES}, max(occ['occ.voxelize_mean']))


def waymo_phases(card, dev):
    """Phase 16: Waymo TransFusion-L and LC at full width on the Waymo
    scene: the encoder's capacities measured and held to ``WAYMO``'s; the
    TransFusion-L path (``drive``: every kernel against its plain version,
    launches 8/21, the twin), the LC model on its weights (without images
    its outputs; one counted frame: launches, overflow, finite 7-wide
    boxes, the share on an image, ms/frame), and one TransFusion-L step
    under the config's recipe (``drive_train`` without the twin, see
    ``WAYMO``; phase 11's launches). The
    only drop allowed is the configured voxel capacity's."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.utils import overflow
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    label = 'Waymo TransFusion-L'
    cfg = load_config(str(WAYMO['config']))
    cap_voxels = cfg.model.pts_voxel_layer.max_voxels[1]
    inputs, gt = make_lc_scene(WAYMO['config_lc'], WAYMO['dataset'],
                               WAYMO['n_points'], WAYMO['img_hw'], dev)
    occ, n_voxels = probe_caps(dev, inputs)
    rounded = [-(-occ[site] // 256) * 256 for site in ENC_SITES]
    print(f'{label}: the scene\'s {WAYMO["n_points"]} points fill '
          f'{n_voxels} voxels (capacity {cap_voxels}); the encoder\'s '
          f'strided outputs {occ}, rounded up to 256: {rounded}; capacities '
          f'{WAYMO["enc_caps"]}', flush=True)
    check(all(o <= c for o, c in zip(rounded, WAYMO['enc_caps'])),
          f'{label}: the encoder outputs {rounded} exceed the capacities '
          f'{WAYMO["enc_caps"]}')
    drop = {'voxelize.mean_batch.voxel_cap': n_voxels - cap_voxels} \
        if n_voxels > cap_voxels else {}
    model = build_model(dev, config=WAYMO['config'], n_caps=WAYMO['enc_caps'])
    calibrate_norms(model, *inputs[:2])
    spec = dict(WAYMO, overflow=drop)
    drive(label, model, inputs[:2], spec, card, reps=dict(kernel=4, frame=3))
    with torch.no_grad():
        preds, boxes = forward(model, inputs[:2])
    ref = dict(preds, **boxes)

    lc_label = 'Waymo TransFusion-LC'
    lc = lc_model(dev, WAYMO['config_lc'], model.state_dict(), inputs,
                  caps=WAYMO['enc_caps'], max_voxels=None)
    check(len(lc.pts_bbox_head.decoder) == 1 + 1 + 5,
          f'{lc_label}: {len(lc.pts_bbox_head.decoder)} decoders')
    without_images(lc_label, lc, inputs, ref)
    with torch.no_grad():
        kernels.reset_launches()
        with overflow.capture() as cap:
            _, boxes = forward(lc, inputs)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
    print(f'{lc_label}: launches on the main path: {launches}', flush=True)
    check_launches(lc_label, launches, WAYMO['launches'])
    check_frame(lc_label, lc, cap, boxes, drop)
    image_stages(lc_label, lc, inputs, card)
    with torch.no_grad():
        frame_ms = cuda_ms(lambda: forward(lc, inputs), 3)
    print(f'{lc_label}: e2e {frame_ms:.3f} ms/frame (CUDA events, 3 '
          f'frames), {1e3 / frame_ms:.2f} frames/s [{card}]', flush=True)
    del lc
    torch.cuda.empty_cache()

    recipe = dict(optimizer=dict(cfg.optimizer),
                  optimizer_config=dict(cfg.optimizer_config),
                  lr_config=dict(cfg.lr_config),
                  total_steps=cfg.total_epochs * TL_STEPS_PER_EPOCH,
                  steps_per_epoch=TL_STEPS_PER_EPOCH, frozen=())
    check(recipe['lr_config']['policy'] == 'cyclic'
          and len(cfg.model.train_cfg.pts.code_weights) == 8,
          f'{label}: the config\'s recipe {recipe}')
    print(f'{label} train: {recipe}', flush=True)
    drive_train(model, inputs[:2], gt, card, dict(WAYMO['train'],
                                                   overflow=drop),
                label=f'{label} train', recipe=recipe)
    model.eval()


def flagship_phases(model, inputs, gt, card, specs=(FLAGSHIP, PACKED,
                                                      ONEHOT)):
    """Phases 4-10 on the calibrated flagship (``specs``: the fp32, packed
    and one-hot inference specs). Returns [(records, launches)] of the six
    drives in order; then of phase 8's three bf16 frames (their calls on
    bf16 features: ``match_conv_bf16``'s model path) and of phase 9's exact
    nearest-voxel frame's ``masked_nn``; then of phase 4's and phase 7's
    exact (FFMA) conv kernels: their records on the x3 kernel's calls and
    the launches of a frame on ``MSMD_CONV_GEMM=highest``; then of
    ``match_conv_bf16`` on phase 7's calls (``match_bf16_calls``)."""
    fp32_spec, packed, onehot = specs
    calibrated = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
    lap = phase_laps()
    phases = [drive('MSMDFusion', model, inputs, fp32_spec, card,
                    reps=dict(kernel=10, frame=10))]
    determinism(model, inputs, card)
    exact = ({'gather_gemm_conv': phases[0][0]['gather_gemm_conv']},
             highest_frame('MSMDFusion', model, inputs, card,
                           highest_launches(fp32_spec['launches'])))
    fp32 = path_outputs(model, inputs)
    dense_engines(model, inputs, card)
    lap('4 (MSMDFusion inference)')

    # 5. the MSMDFusion train step
    phases.append(drive_train(model, inputs, gt, card))
    lap('5 (MSMDFusion train)')
    # the fp32 engine's (x3) kernels' records of the calls the packed ones
    # make again
    same_calls = dict(
        inference={'gather_gemm_conv_bf16':
                   phases[0][0]['gather_gemm_conv_x3']},
        train={'conv_dw_bf16': phases[1][0]['conv_dw_x3'],
               'gather_gemm_conv_bf16_bwd':
                   phases[1][0]['gather_gemm_conv_x3_bwd']})

    # 6. the packed bf16 engine, 7. the one-hot engine: the calibrated
    # model again, the switch set around the phase only
    for name, spec in (('packed bf16', packed), ('one-hot', onehot)):
        model.load_state_dict(calibrated)
        model.eval()
        with switches(spec['env']):
            print(f'MSMDFusion {name}: {spec["env"]}', flush=True)
            ratios = same_calls if spec is packed else {}
            phases.append(drive(f'MSMDFusion {name}', model, inputs, spec,
                                card, reps=dict(kernel=4, frame=5),
                                fp32=ratios.get('inference')))
            if spec is packed:
                path_vs(f'MSMDFusion packed bf16 vs fp32 (x3) path [{card}]',
                        model, inputs, fp32)
            else:
                # the exact (FFMA) one-hot conv: its records on the x3
                # kernel's calls, the launches of a frame on highest; then
                # the bf16-feature kernel on the frame's calls
                onehot_extra = [
                    ({'match_conv': phases[-1][0]['match_conv']},
                     highest_frame('MSMDFusion one-hot', model, inputs, card,
                                   highest_launches(spec['launches']))),
                    match_bf16_calls(model, inputs, card)]
            phases.append(drive_train(model, inputs, gt, card, spec['train'],
                                      label=f'MSMDFusion {name} train',
                                      fp32=ratios.get('train')))
        lap(f'{6 if spec is packed else 7} ({name})')
    model.load_state_dict(calibrated)
    model.eval()
    # 8. bf16 compute, 9. the ablation and backend switches, 10. the
    # image branch trained
    later = bf16_frames(model, inputs, card, fp32)
    lap('8 (bf16-compute frames)')
    later += ablation_frames(model, inputs, card)
    lap('9 (switch frames)')
    image_train_step(model, inputs, gt, card)
    lap('10 (image-branch train)')
    engines_interleaved(model, inputs, card, (
        ('fp32', {}), ('fp32 highest', HIGHEST['env']),
        ('packed bf16', packed['env']), ('one-hot', onehot['env'])))
    lap('engines interleaved')
    return phases + later + [exact] + onehot_extra


def engines_interleaved(model, inputs, card, engines, rounds=6):
    """The conv engines' frames interleaved, one frame of each (name, env)
    per round after a warm-up round, so that the host's drift over the
    call falls on all of them alike (the frame is host-bound): per engine
    the median, least and most ms of the frame (CUDA events around the
    forward, its sections recording) and of its stage ``plans`` by CUDA
    events and by the host's clock, and the medians' ratio to the first
    engine's. Before the rounds, one forward of each engine counts the
    host's synchronisations with the device (PyTorch's sync debug mode)
    and prints the sites that made most of them."""
    import collections
    import statistics
    import warnings
    import torch
    from msmdfusion_torch.utils import timing
    with torch.no_grad():
        for name, env in engines:
            with switches(env), warnings.catch_warnings(record=True) as got:
                warnings.simplefilter('always')
                torch.cuda.set_sync_debug_mode('warn')
                try:
                    forward(model, inputs)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            sites = collections.Counter(
                f'{w.filename.rsplit("/", 2)[-1]}:{w.lineno}' for w in got
                if 'synchroniz' in str(w.message))
            print(f'MSMDFusion engines interleaved: {name} synchronises '
                  f'{sum(sites.values())} times a frame; most at '
                  f'{sites.most_common(6)} [{card}]', flush=True)
    frames = {name: [] for name, _ in engines}
    plans = {name: [] for name, _ in engines}
    plans_host = {name: [] for name, _ in engines}
    with torch.no_grad():
        for r in range(rounds + 1):
            for name, env in engines:
                with switches(env):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    with timing.record('cuda') as tr:
                        start.record()
                        forward(model, inputs)
                        end.record()
                    stages = tr.ms()
                if r:
                    frames[name].append(start.elapsed_time(end))
                    plans[name].append(stages.get('plans', 0.0))
                    plans_host[name].append(tr.host_ms().get('plans', 0.0))
    base = statistics.median(frames[engines[0][0]])
    for name, _ in engines:
        f, p, h = frames[name], plans[name], plans_host[name]
        print(f'MSMDFusion engines interleaved, {rounds} frames each: {name} '
              f'{statistics.median(f):.3f} ms/frame median (min {min(f):.3f}, '
              f'max {max(f):.3f}; {statistics.median(f) / base:.3f} of '
              f'{engines[0][0]}), stage plans {statistics.median(p):.3f} ms '
              f'median (min {min(p):.3f}, max {max(p):.3f}), host clock '
              f'{statistics.median(h):.3f} median (min {min(h):.3f}, max '
              f'{max(h):.3f}) [{card}]', flush=True)


# phase 17: the system's own entry points on files. A nuScenes-layout
# dataset of full-size samples (``write_nuscenes``): phase 4's frame
# (``realistic_batch``'s, on which FLAGSHIP's capacities were measured:
# the same generator's other seeds overflow them) split over each
# keyframe's .bin and 9 sweeps, six 900 x 1600 uint8 views of noise
# (.npy, read without PIL) on the same rig, the MDU artifacts of its
# objects with the virtual points split over the keyframe and its sweeps,
# its GT. The timed pass reads a second info file that lists the samples
# ``timed`` times over; its first ``2 x workers`` samples (start-up and
# the loader's prefetch) are left out of the rates. The train CLI's
# batch of two augmented frames runs at ``train_caps`` times FLAGSHIP's
# capacities: at twice them (one frame's each) its steps dropped up to
# 15% of a stage's rows (PERF.md section 6, PR 14)
ENTRY = dict(samples=4, sweeps=9, img_hw=(900, 1600), num_virtual=200,
             steps=3, timed=40, timed_one_worker=8, train_caps=3)


def flagship_frame(pcr, shape=FLAGSHIP['shape'], seed=SEED):
    """(points, objects) of ``realistic_batch(shape, b=1, seed=seed)``'s
    frame: its generator draws the images first, then the scene."""
    import numpy as np
    from msmdfusion_torch.utils.synth_scene import lidar_scene
    rng = np.random.RandomState(seed)
    rng.randn(1, shape['v'], *shape['img_hw'], 3)
    return lidar_scene(rng, shape['n'], pcr)


def camera_info(lidar2img):
    """A view's calibration as the nuScenes infos hold it (intrinsic,
    sensor2lidar rotation and translation) from its lidar2img: K R = M by
    a QR factorisation of M^-1, K's diagonal made positive."""
    import numpy as np
    m = np.asarray(lidar2img, np.float64)
    q, r = np.linalg.qr(np.linalg.inv(m[:3, :3]))
    k, rot = np.linalg.inv(r), q.T
    sign = np.diag(np.sign(np.diag(k)))
    k, rot = k @ sign, sign @ rot
    return dict(cam_intrinsic=k, sensor2lidar_rotation=rot.T,
                sensor2lidar_translation=-rot.T @ np.linalg.solve(k,
                                                                  m[:3, 3]))


def split_artifact(artifact, parts):
    """``artifact`` as ``parts`` artifacts: the virtual rows of each
    camera split in order, the real ones all in the first (a sweep's
    artifact adds its virtual points only); together they hold the rows of
    ``artifact``, so the capacities see the same counts."""
    import numpy as np
    out = [dict(artifact, virtual_points=[], virtual_pixel_indices=[])
           for _ in range(parts)]
    for part in out[1:]:
        part.update(real_points=[r[:0] for r in artifact['real_points']],
                    real_pixel_indices=[r[:0] for r in
                                        artifact['real_pixel_indices']])
    for key in ('virtual_points', 'virtual_pixel_indices'):
        for rows in artifact[key]:
            for part, chunk in zip(out, np.array_split(rows, parts)):
                part[key].append(chunk)
    return out


def write_nuscenes(root, pts, objects, spec=ENTRY):
    """Write ``spec['samples']`` samples of the frame (``pts``,
    ``objects``) in the nuScenes layout under ``root`` (samples/LIDAR_TOP,
    sweeps/LIDAR_TOP, samples/CAM_*, {samples,sweeps}/FOREGROUND_MIXED_6NN_
    WITH_DEPTH), each with its own split of the points over the sweeps and
    its own views, the info file ``nuscenes_infos.pkl`` and the timed
    pass's ``nuscenes_infos_timed.pkl`` (the samples ``spec['timed']``
    times over, each entry its own token); returns their paths."""
    import pickle
    import numpy as np
    from msmdfusion_torch.datasets.nuscenes import CAM_ORDER, NuScenesDataset
    from msmdfusion_torch.utils.synth_scene import (camera_rig,
                                                    foreground_artifact,
                                                    scene_gt)
    root = Path(root)
    fg = 'FOREGROUND_MIXED_6NN_WITH_DEPTH'
    dirs = {d: root / d for d in (
        'samples/LIDAR_TOP', 'sweeps/LIDAR_TOP', f'samples/{fg}',
        f'sweeps/{fg}', *(f'samples/{c}' for c in CAM_ORDER))}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    l2i = camera_rig(spec['img_hw'], len(CAM_ORDER), seed=SEED)
    artifacts = [np.asarray(a, dtype=object) for a in split_artifact(
        foreground_artifact(pts, objects, l2i, spec['img_hw'],
                            spec['num_virtual'], SEED), spec['sweeps'] + 1)]
    boxes, labels, valid = scene_gt(objects)
    infos = []
    for i in range(spec['samples']):
        rng = np.random.RandomState(SEED + i)
        parts = np.array_split(rng.permutation(len(pts)), spec['sweeps'] + 1)
        ts = 1_500_000_000_000_000 + i * 500_000           # microseconds
        key = dirs['samples/LIDAR_TOP'] / f'sample{i}.bin'
        pts[parts[0]].tofile(key)
        np.save(dirs[f'samples/{fg}'] / f'{key.name}.pkl.npy', artifacts[0])
        sweeps = []
        for j, part in enumerate(parts[1:]):
            path = dirs['sweeps/LIDAR_TOP'] / f'sample{i}_sweep{j}.bin'
            pts[part].tofile(path)
            np.save(dirs[f'sweeps/{fg}'] / f'{path.name}.pkl.npy',
                    artifacts[j + 1])
            sweeps.append(dict(data_path=str(path),
                               timestamp=ts - 50_000 * (j + 1),
                               sensor2lidar_rotation=np.eye(3),
                               sensor2lidar_translation=np.zeros(3)))
        cams = {}
        for v, cam in enumerate(CAM_ORDER):
            path = dirs[f'samples/{cam}'] / f'sample{i}.npy'
            np.save(path, rng.randint(0, 256, (*spec['img_hw'], 3),
                                      dtype=np.uint8))
            cams[cam] = dict(data_path=str(path), **camera_info(l2i[v]))
        infos.append(dict(
            token=f'sample{i}', lidar_path=str(key), timestamp=ts,
            sweeps=sweeps, cams=cams, gt_boxes=boxes[valid, :7],
            gt_names=np.array([NuScenesDataset.CLASSES[c]
                               for c in labels[valid]]),
            gt_velocity=boxes[valid, 7:9]))
    paths = []
    for name, entries in (
            ('nuscenes_infos.pkl', infos),
            ('nuscenes_infos_timed.pkl',
             [dict(infos[k % len(infos)], token=f'sample{k % len(infos)}_{k}')
              for k in range(spec['timed'])])):
        paths.append(root / name)
        with open(paths[-1], 'wb') as f:
            pickle.dump(dict(infos=entries,
                             metadata=dict(version='v1.0-trainval')), f)
    return paths


def capacity_options(caps, scale=1):
    """``--cfg-options`` of ``caps`` (``FLAGSHIP``'s), each times
    ``scale`` (the batch's samples: the capacities hold a batch)."""
    def joined(key):
        return ','.join(str(c * scale) for c in caps[key])
    v = caps['max_voxels'] * scale
    return [f'model.pts_voxel_layer.max_voxels={v},{v}',
            f'model.pts_middle_encoder.stage_capacities={joined("enc_caps")}',
            'model.multimodal_middle_encoder.stage_capacities='
            + joined('gma_caps'),
            'model.multimodal_middle_encoder.union_capacities='
            + joined('union_caps'),
            f'model.fg_max_voxels={joined("fg_caps")}']


def data_options(split, root, ann):
    return [f'data.{split}.data_root={root}/', f'data.{split}.ann_file={ann}']


def steady_ms(times, skip):
    """ms between successive entries of ``times`` (seconds) from the
    ``skip``-th on."""
    return (times[-1] - times[skip]) * 1e3 / (len(times) - 1 - skip)


def pipeline_ms(dataset, workers, count):
    """Host ms per sample of the loader alone over the first ``count``
    samples of ``dataset`` with ``workers`` worker processes, from its
    ``2 x workers``-th sample on (start-up and the prefetch left out)."""
    from msmdfusion_torch.datasets.loader import DataLoader
    times = []
    with DataLoader(dataset, 1, shuffle=False, drop_last=False,
                    num_workers=workers) as loader:
        for _ in loader:
            times.append(time.perf_counter())
            if len(times) == count:
                break
    return steady_ms(times, 2 * workers)


def json_records(work):
    out = []
    for path in sorted(Path(work).glob('*.log.json')):
        out += [json.loads(line) for line in path.read_text().splitlines()]
    return out


def entry_points(card, dev, spec=ENTRY, caps=FLAGSHIP, then=None):
    """Phase 17: the eval and train CLIs (``msmdfusion_torch.tools``) on
    the flagship config with ``caps`` through ``--cfg-options``, from
    ``write_nuscenes``' files (see the module docstring). ``then(files)``
    runs last, on the same files, in the same working directory
    (dict(config, checkpoint: the seed's weights, out: the eval CLI's
    ``--out`` pickle, test_opts, train_opts, card, dev, root: the
    dataset's directory, ann: its info file, timed_ann: the info file of
    the timed pass, work: the train CLI's work directory))."""
    import multiprocessing
    import tempfile
    import numpy as np
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.inference import (batch_model_inputs,
                                                 unpack_detections)
    from msmdfusion_torch.config import load_config, parse_cli_overrides
    from msmdfusion_torch.datasets.loader import DataLoader
    from msmdfusion_torch.models.builder import build_detector
    from msmdfusion_torch.registry import DATASETS
    from msmdfusion_torch.tools import test as test_cli
    from msmdfusion_torch.tools import train as train_cli
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    from msmdfusion_torch.utils import overflow
    from msmdfusion_torch.utils.checkpoint import save_checkpoint
    config = str(caps['config'])
    label = 'entry points'
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        pts, objects = flagship_frame(load_config(config).point_cloud_range,
                                      caps['shape'])
        ann, timed_ann = write_nuscenes(Path(tmp) / 'nuscenes', pts,
                                        objects, spec)
        print(f'{label}: {spec["samples"]} samples written in '
              f'{time.perf_counter() - t0:.1f} s (phase 4\'s {len(pts)} '
              f'points and its virtual points over 1 + {spec["sweeps"]} '
              f'files, six {spec["img_hw"]} uint8 views)', flush=True)
        del pts, objects
        root = ann.parent
        test_opts = capacity_options(caps) + data_options('test', root, ann)

        # a checkpoint: the seed's weights, norms calibrated on sample 0
        cfg = load_config(config, parse_cli_overrides(test_opts))
        dataset = DATASETS.build(dict(cfg.data.test))
        model = build_detector(cfg.model, device=dev, seed=SEED)
        with DataLoader(dataset, 1, shuffle=False, drop_last=False,
                        num_workers=0, device=dev) as loader:
            inputs = batch_model_inputs(cfg.model.type, next(iter(loader)),
                                        dev)
        fg = inputs[3]
        swept = int((fg['fg_points'][..., -1][fg['fg_mask']] > 0).sum())
        check(swept > 0, f'{label}: no foreground point from a sweep')
        with torch.no_grad():
            calibrate_norms(model, *inputs)
        ckpt = save_checkpoint(tmp, 0, model, meta=dict(config=config))
        del model

        # the eval CLI, --out --eval bbox, its launches counted
        kernels.reset_launches()
        run = test_cli.main([config, ckpt, '--out', str(Path(tmp) / 'r.pkl'),
                             '--eval', 'bbox', '--device', str(dev),
                             '--cfg-options', *test_opts])
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        n = len(run['results'])
        check(n == spec['samples'], f'{label}: {n} results')
        print(f'{label}: eval CLI launches over {n} frames {launches}',
              flush=True)
        check_launches(f'{label}: eval CLI', launches,
                       {k: v * n for k, v in caps['launches'].items()})
        total = sum(run['overflow'].values())
        check(total == 0, f'{label}: eval CLI overflow {run["overflow"]}')
        check({'mAP', 'NDS'} <= set(run['metrics']),
              f'{label}: metrics {run["metrics"]}')
        for det in run['results']:
            check(np.isfinite(det['bboxes']).all()
                  and det['bboxes'].shape[1] == 9, f'{label}: boxes')
        model = run['model']
        with torch.no_grad():
            direct = unpack_detections(model.get_bboxes(model(*inputs)))[0]
        for key in ('bboxes', 'scores', 'labels'):
            check(np.array_equal(run['results'][0][key], direct[key]),
                  f'{label}: sample 0 {key} differ from the direct call')
        print(f'{label}: eval CLI: overflow_total {total}; {swept} of '
              f'sample 0\'s {int(fg["fg_mask"].sum())} foreground points '
              f'from its sweeps\' artifacts; sample 0\'s '
              f'{len(direct["scores"])} detections bit-equal to '
              'model.get_bboxes(model(...)) on the same batch; mAP '
              f'{run["metrics"]["mAP"]:.4f} NDS {run["metrics"]["NDS"]:.4f}'
              ' (seed weights: no meaning)', flush=True)
        with torch.no_grad():
            frame_ms = cuda_ms(lambda: forward(model, inputs), 5)
        print(f'{label}: eval CLI, whole run {run["fps"]:.3f} frames/s '
              f'({run["seconds"]:.2f} s for {n} frames, worker start-up in '
              f'it) [{card}]', flush=True)
        del run, model, inputs, fg

        # the timed pass: the eval CLI over the samples listed
        # spec['timed'] times, and the pipeline alone on the same entries
        workers, skip = cfg.data.workers_per_gpu, 2 * cfg.data.workers_per_gpu
        timed_opts = capacity_options(caps) + data_options('test', root,
                                                           timed_ann)
        run = test_cli.main([config, ckpt, '--device', str(dev),
                             '--cfg-options', *timed_opts])
        n_timed = len(run['results'])
        check(n_timed == spec['timed'] and not sum(run['overflow'].values()),
              f'{label}: timed pass {n_timed} results, overflow '
              f'{run["overflow"]}')
        cli_ms = steady_ms(run['frame_s'], skip)
        timed = run['dataset']
        del run
        one = pipeline_ms(timed, 1, spec['timed_one_worker'])
        many = pipeline_ms(timed, workers, spec['timed'])
        print(f'{label}: timed pass, {spec["timed"]} frames: eval CLI '
              f'{1e3 / cli_ms:.3f} frames/s ({cli_ms:.1f} ms/frame from '
              f'frame {skip} on, host clock); pipeline alone {one:.1f} '
              f'ms/sample with 1 worker (from sample 2 of '
              f'{spec["timed_one_worker"]}), {many:.1f} with {workers} (from '
              f'sample {skip} of {spec["timed"]}); model {frame_ms:.3f} ms/frame (CUDA events, 5 frames of '
              f'sample 0) [{card}]', flush=True)

        run = test_cli.main([config, ckpt, '--format-only', '--device',
                             str(dev), '--cfg-options', *test_opts])
        with open(run['submission']) as f:
            sub = json.load(f)
        fields = {'sample_token', 'translation', 'size', 'rotation',
                  'velocity', 'detection_name', 'detection_score',
                  'attribute_name'}
        check(set(sub) == {'meta', 'results'} and len(sub['results']) == n
              and all(set(a) == fields for annos in sub['results'].values()
                      for a in annos), f'{label}: submission schema')
        print(f'{label}: --format-only: {run["submission"]} with '
              f'{sum(map(len, sub["results"].values()))} boxes; '
              f'{run["fps"]:.3f} frames/s whole run [{card}]', flush=True)
        del run

        # the train CLI: the config's stage-2 recipe under CBGS, its two
        # augmented samples a batch at spec['train_caps'] x the capacities
        work = str(Path(tmp) / 'work')
        train_opts = (capacity_options(caps, spec['train_caps'])
                      + data_options('train.dataset', root, ann)
                      + data_options('val', root, ann)
                      + ['evaluation.interval=1', 'evaluation.max_samples=1',
                         'log_config.interval=1'])
        args = [config, '--work-dir', work, '--device', str(dev),
                '--cfg-options', *train_opts]
        kernels.reset_launches()
        t0 = time.perf_counter()
        with overflow.capture() as cap:
            run = train_cli.main(args + ['--max-steps', str(spec['steps'])])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        train_dropped = {k: v for k, v in cap.counters().items() if v}
        launches = dict(kernels.launches)
        expected = {k: spec['steps'] * v + caps['launches'].get(k, 0)
                    for k, v in TRAIN['launches'].items()}
        print(f'{label}: train CLI launches over {spec["steps"]} steps and '
              f'1 val frame {launches}', flush=True)
        check_launches(f'{label}: train CLI', launches, expected)
        records = json_records(work)
        train = [r for r in records if r['mode'] == 'train']
        val = [r for r in records if r['mode'] == 'val']
        check(len(train) == spec['steps']
              and all(math.isfinite(r['total_loss']) for r in train),
              f'{label}: train records {train}')
        check(len(val) == 1 and 'NDS' in val[0], f'{label}: val {val}')
        check(run['checkpoint'] == str(Path(work) / f'ckpt_{spec["steps"]}')
              and Path(run['checkpoint']).is_file()
              and list(Path(work, 'tf_logs').glob('events.out.tfevents.*')),
              f'{label}: checkpoint or event file missing')
        dropped = {k: v for k, v in val[0].items()
                   if k.startswith('overflow/') and v}
        check(not train_dropped and not dropped and any(
            k.startswith('overflow/') for k in val[0]),
              f'{label}: train CLI overflow: steps {train_dropped}, val '
              f'{dropped}')
        print(f'{label}: train CLI: {spec["steps"]} steps + checkpoint + 1 '
              f'val frame in {seconds:.1f} s; total_loss '
              f'{[round(r["total_loss"], 4) for r in train]}, samples/s '
              f'{[r["samples_per_s"] for r in train]}; overflow 0 in the steps '
              f'and the val frame at {spec["train_caps"]}x the capacities '
              f'[{card}]', flush=True)
        after = {k: v.detach().clone()
                 for k, v in run['model'].state_dict().items()}
        first, ckpt = run['batches'], run['checkpoint']
        del run
        torch.cuda.empty_cache()

        again = train_cli.main(args + ['--max-steps',
                                       str(spec['steps'] + 1),
                                       '--no-validate'])
        check(again['start_step'] == spec['steps']
              and again['step'] == spec['steps'] + 1
              and again['batches'] == first[:1],
              f'{label}: resume at {again["start_step"]} with batches '
              f'{again["batches"]}, the fresh run\'s {first}')
        print(f'{label}: resumed at step {again["start_step"]}, epoch 0 '
              f'again from its first batch {again["batches"][0]} (the fresh '
              f'run\'s batches {first})', flush=True)
        del again
        torch.cuda.empty_cache()

        run = test_cli.main([config, ckpt, '--max-samples', '1', '--device',
                             str(dev), '--cfg-options', *test_opts])
        state = run['model'].state_dict()
        check(set(state) == set(after)
              and all(torch.equal(state[k], after[k]) for k in after),
              f'{label}: the eval CLI\'s model differs from the state after '
              f'step {spec["steps"]}')
        print(f'{label}: the eval CLI loaded {ckpt}: {len(after)} tensors '
              f'bit-equal to the state after step {spec["steps"]}',
              flush=True)
        del run, after
        torch.cuda.empty_cache()
        if then is not None:
            then(dict(config=config, checkpoint=str(Path(tmp) / 'ckpt_0'),
                      out=str(Path(tmp) / 'r.pkl'), test_opts=test_opts,
                      train_opts=train_opts, card=card, dev=dev, root=root,
                      ann=ann, timed_ann=timed_ann, work=work))
    check(not multiprocessing.active_children(),
          f'{label}: worker processes left')
    torch.cuda.empty_cache()


# phase 18: the flagship data-parallel, every part in child processes (the
# main process joins no group): the step at FLAGSHIP's capacities times
# ``caps`` on a realistic batch of two frames (the encoder's and the GMA's
# capacities hold a batch: twice phase 17's 3x a frame would be 6; the
# second frame of the batch needs less, and every step is checked to drop
# nothing), ``timed`` steps timed on each side; the CLIs on phase 17's
# files, each rank's pipeline on ``cli_workers`` workers, the train CLI
# one step, then resumed from that checkpoint to two
DIST = dict(caps=4, timed=2, cli_workers=2, timeout=600)
ADAM_EPS = 1e-8                 # apis.train.ClippedAdamW's default


def scaled_caps(scale, caps=FLAGSHIP):
    """``caps`` with every capacity times ``scale``."""
    return dict(caps, max_voxels=caps['max_voxels'] * scale, **{
        k: [c * scale for c in caps[k]]
        for k in ('enc_caps', 'gma_caps', 'union_caps', 'fg_caps')})


class Reordered:
    """Inside the scope the training step's sums run in another fp32
    order: every batch norm takes its moments by the port's two-pass
    formula (``layers.global_moments``, the dense norms too, as inside a
    process group, without one) over its rows in reverse order, and the
    dense convs run off cuDNN (another algorithm). That is what splitting
    a batch over ranks does to the step (each rank's partial sums, then
    their sum; cuDNN's algorithm for the smaller batch): the spread of
    this step from the plain one measures what the model makes of it, as
    phase 5's reordered sums do for the sparse convs."""

    def __enter__(self):
        import torch
        from msmdfusion_torch.models import layers
        self._layers = layers
        self._orig = layers.grouped, layers.all_sum, layers.global_moments
        moments = layers.global_moments

        def reversed_rows(xf, dims, weight=None):
            flip = [d % xf.dim() for d in dims]
            return moments(xf.flip(flip), dims, None if weight is None
                           else weight.flip([d for d in flip
                                             if weight.shape[d] > 1]))
        layers.grouped = lambda: True
        layers.all_sum = lambda x: x
        layers.global_moments = reversed_rows
        self._cudnn = torch.backends.cudnn.flags(enabled=False)
        self._cudnn.__enter__()
        return self

    def __exit__(self, *exc):
        self._cudnn.__exit__(*exc)
        (self._layers.grouped, self._layers.all_sum,
         self._layers.global_moments) = self._orig
        return False


class Collectives:
    """Count the collectives of ``torch.distributed`` called inside the
    scope, by name."""
    NAMES = ('all_reduce', 'broadcast', 'all_gather', 'all_gather_object',
             'barrier')

    def __enter__(self):
        import torch.distributed as dist
        self.counts = dict.fromkeys(self.NAMES, 0)
        self._orig = {n: getattr(dist, n) for n in self.NAMES}
        for name, fn in self._orig.items():
            def counted(*a, _name=name, _fn=fn, **k):
                self.counts[_name] += 1
                return _fn(*a, **k)
            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self._orig.items():
            setattr(dist, name, fn)
        return False


class BatchReluMasks(ReluMasks):
    """``ReluMasks`` for the ReLUs whose masks a split batch can share:
    inside the scope every ReLU called with autograd on an input with a
    batch axis (three or more dims, the batch's rows leading: the BEV maps,
    the head's queries, the foreground points) records its mask or, given
    ``masks`` recorded over the global batch, applies this rank's rows of
    them (``local_batch_slice`` of ``world``), in call order. ReLUs without
    autograd (the frozen image branch) and on sparse rows [rows, C] (laid
    out by the whole batch's keys) decide for themselves."""

    def __init__(self, masks=None, rank=0, world=1):
        super().__init__(masks)
        self.rank, self.world = rank, world

    def relu(self, x, inplace=False):
        import torch
        from msmdfusion_torch.parallel import local_batch_slice
        if x.dim() < 3 or not torch.is_grad_enabled():
            return self._orig[0](x)
        if self.replay:
            mask = self.masks[self.calls]
            mask = mask[local_batch_slice(mask.shape[0], self.rank,
                                          self.world)]
            check(mask.shape == x.shape, f'ReLU call {self.calls}: shape '
                  f'{tuple(x.shape)}, recorded {tuple(mask.shape)}')
            out = torch.where(mask, x, 0.0)
        else:
            self.masks.append(x > 0)
            out = self._orig[0](x)
        self.calls += 1
        return out


class PinnedTargets:
    """Inside the scope the head's ``get_targets`` returns ``targets``
    (another step's assignment and targets) in place of assigning anew;
    with ``targets`` None it assigns and keeps what it returned there."""

    def __init__(self, head, targets=None):
        self.head, self.targets, self._keep = head, targets, targets is None

    def __enter__(self):
        assign = self.head.get_targets

        def get_targets(*a, **k):
            if self._keep:
                self.targets = assign(*a, **k)
            return self.targets
        self.head.get_targets = get_targets
        return self

    def __exit__(self, *exc):
        del self.head.get_targets
        return False


def rank_pins(pins, rank, world):
    """This rank's share of a step's proposals, targets and ReLU masks
    (``dist_step``'s ``pins`` over the global batch): its rows of the
    proposals and targets, its own count of positives, the matched IoU a
    world-th each (its share of the metric), the masks whole
    (``BatchReluMasks`` takes the rank's rows of each)."""
    from msmdfusion_torch.parallel import shard_batch
    labels, lw, boxes, weights, _, _, heatmap = shard_batch(
        pins['targets'], rank, world)
    return dict(index=shard_batch(pins['index'], rank, world),
                targets=(labels, lw, boxes, weights,
                         (weights[..., 0] > 0).sum(), pins['targets'][5] /
                         world, heatmap),
                relu=pins['relu'], rank=rank, world=world)


def dist_step(label, model, start, batch, card, scopes=(), timed=0,
              pins=None):
    """One ``make_train_step`` of phase 5's recipe from the state ``start``
    on ``batch`` (inside a group, this rank's share of the global batch),
    then ``timed`` more steps split and timed (``split_steps``): dict(metrics,
    grads, state after the first step, launches, collectives, overflow:
    this rank's and summed over the ranks, split, pins). The first step
    runs inside ``scopes`` and, given ``pins`` (``rank_pins`` of another
    step on the same samples), on that step's proposals, assignment and
    batch-axis ReLU masks (``BatchReluMasks``), as phase 5's twin does:
    each is a discrete function of the values, and at full scale rounding
    alone can turn a near-tie; without ``pins`` it records its own."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.train import (build_lr_schedule,
                                             build_optimizer,
                                             make_train_step)
    from msmdfusion_torch.utils import overflow
    model.load_state_dict(start)
    opt = build_optimizer(
        model, TRAIN['optimizer'], TRAIN['optimizer_config'],
        build_lr_schedule(TRAIN['lr_config'], TRAIN['optimizer']['lr'],
                          TRAIN['total_steps'], TRAIN['steps_per_epoch']),
        frozen_prefixes=TRAIN['frozen'])
    step = make_train_step(model, opt, seed=SEED)
    seen = {}
    with contextlib.ExitStack() as stack:
        for scope in scopes:
            stack.enter_context(scope)
        targets = stack.enter_context(PinnedTargets(
            model.pts_bbox_head, pins and pins['targets']))
        relu = stack.enter_context(BatchReluMasks(
            *(() if pins is None else (pins['relu'], pins['rank'],
                                       pins['world']))))
        if pins is not None:
            stack.enter_context(PinnedProposals(pins['index']))
        else:
            def keep(module, args, out):
                seen.setdefault('index', proposal_index(out))
            hook = model.register_forward_hook(keep)
            stack.callback(hook.remove)
        with Collectives() as coll, overflow.capture() as cap:
            kernels.reset_launches()
            metrics = step(batch, 0)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
    rec = dict(metrics={k: float(v) for k, v in metrics.items()},
               grads={n: p.grad.detach().to('cpu', copy=True)
                      for n, p in model.named_parameters()
                      if p.grad is not None},
               state={k: v.detach().to('cpu', copy=True)
                      for k, v in model.state_dict().items()},
               launches=launches, collectives=coll.counts,
               overflow=cap.counters(),
               overflow_global=cap.global_counters(),
               pins=None if pins is not None else dict(
                   index=seen['index'].cpu(),
                   targets=tuple(t.cpu() for t in targets.targets),
                   relu=[m.cpu() for m in relu.masks]))
    rec['split'] = split_steps(label, step, model, opt, batch, timed,
                               card) if timed else []
    return rec


def step_ms(rec):
    return [round(sum(s), 1) for s in rec['split']]


def dist_rows(run, ref, alt, start):
    """``run`` against ``ref`` (``dist_step`` records), ``alt`` the
    reference step with its sums reordered (``Reordered``): the loss
    terms, ``grad_norm``, every gradient, running statistic and parameter
    update, each within ``FLOOR_MARGIN`` times ``alt``'s spread from
    ``ref``, never less than ``TOL`` of its largest value (phase 5's twin
    limits after the decoder: the split moves the head-input gradient
    too, so the rule holds below the head as well). An update is held to
    its limit times the learning rate's scale: Adam's first step moves a
    parameter by about the rate whatever its gradient, so where the
    gradient lies within ten times its limit of 0 (its sign unsettled), or
    its clipped value within 100 times Adam's eps of 0 (the update then
    follows the clip's scale, ``grad_norm``), the update may differ by up
    to 2.01 times the rate; 4 ulp of the parameter for its rounding.
    Returns [(error over max |ref|, limit, spread, name)], worst first by
    error over limit."""
    import torch
    from msmdfusion_torch.apis.train import build_lr_schedule
    rows = []
    lr = build_lr_schedule(TRAIN['lr_config'], TRAIN['optimizer']['lr'],
                           TRAIN['total_steps'], TRAIN['steps_per_epoch'])(0)

    def held(name, got, want, other):
        got, want, other = (torch.as_tensor(x, dtype=torch.float64)
                            for x in (got, want, other))
        rel = rel_err(got, want)[1]
        spread = rel_err(other, want)[1]
        rows.append((rel, max(TOL, FLOOR_MARGIN * spread), spread, name))

    for key, want in ref['metrics'].items():
        if 'loss' in key or key == 'grad_norm':
            held(key, run['metrics'][key], want, alt['metrics'][key])
    check(set(run['grads']) == set(ref['grads']),
          'the split and whole steps give gradients to different '
          'parameters')
    limits = {}
    for name, want in ref['grads'].items():
        held(name, run['grads'][name], want, alt['grads'][name])
        limits[name] = rows[-1][1] * float(want.abs().max())
    # the clip's scale on the first step (Adam's first update is g over
    # |g| + eps: where the clipped |g| nears eps it follows the scale)
    clip = TRAIN['optimizer_config']['grad_clip']['max_norm']
    scale = min(1.0, clip / ref['metrics']['grad_norm'])
    for name, want in ref['state'].items():
        if name.endswith(('running_mean', 'running_var')):
            held(name, run['state'][name], want, alt['state'][name])
        elif name in limits:
            g = ref['grads'][name]
            moved = want.double() - start[name].double()
            got = run['state'][name].double() - start[name].double()
            settled = (g.abs() > 10 * limits[name]) & (
                g.abs() * scale > 100 * ADAM_EPS)
            allowed = torch.where(settled, 1e-3 * lr, 2.01 * lr) \
                + 2 ** -21 * want.double().abs()       # 4 ulp of fp32
            err = float(((got - moved).abs() / allowed).max())
            rows.append((err, 1.0, 0.0, f'{name} update'))
    rows.sort(key=lambda r: r[0] / r[1], reverse=True)
    return rows


def norm_parts(run, ref, alt, top=5):
    """The ``top`` largest parts of the reference's squared ``grad_norm``:
    [(name, share, that tensor's norm in ``run`` and ``alt`` over ref's)]."""
    parts = sorted(((float(g.double().pow(2).sum()), n)
                    for n, g in ref['grads'].items()), reverse=True)
    total = sum(p for p, _ in parts)
    return [(n, round(p / total, 4),
             round(float(run['grads'][n].double().norm()) / p ** 0.5, 4),
             round(float(alt['grads'][n].double().norm()) / p ** 0.5, 4))
            for p, n in parts[:top]]


def worst(rows):
    """The worst held value and the worst update of ``dist_rows``."""
    held = [r for r in rows if not r[3].endswith(' update')]
    updates = [r for r in rows if r[3].endswith(' update')]
    rel, limit, spread, name = held[0]
    return (f'worst {rel:.3g} of max |ref| against a limit of {limit:.3g} '
            f'({name}; reordered spread {spread:.3g}) of {len(held)} '
            f'values; updates at worst {updates[0][0]:.3g} of their '
            f'allowance ({updates[0][3]}) of {len(updates)}')


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def run_children(fn, world, args, label, timeout=DIST['timeout']):
    """``fn(rank, world, port, *args)`` in ``world`` spawned processes (a
    free localhost port for their group), waited for; a child that fails
    or outlives ``timeout`` seconds fails the phase, and every child is
    stopped."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world, free_port(), *args),
                             nprocs=world, join=False, start_method='spawn')
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            check(time.monotonic() < deadline,
                  f'{label}: {world} ranks still running after {timeout} s')
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


def manual_env(rank, world, port):
    import os
    os.environ.update(MSMD_COORDINATOR=f'127.0.0.1:{port}',
                      MSMD_NUM_PROCESSES=str(world),
                      MSMD_PROCESS_ID=str(rank))


def tensor_digests(state):
    """{name: sha256 of the tensor's bytes} of a state dict."""
    import hashlib
    import torch
    return {k: hashlib.sha256(v.detach().cpu().contiguous().reshape(-1)
                              .view(torch.uint8).numpy().tobytes()
                              ).hexdigest() for k, v in state.items()}


def moved(x, dev):
    """``x`` (tensors in nested dicts, lists and tuples) on ``dev``."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: moved(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(moved(v, dev) for v in x)
    return x


def step_child(rank, world, port, work, part, backend, card):
    """A rank of phase 18 (a)/(b): joins a group of ``world`` (``manual``
    launcher, ``backend``; on ``cuda:0`` for gloo, where the ranks share a
    card), loads the calibrated weights, the batch and the reference
    step's proposals and assignment that ``work`` holds for ``part``
    (dict(samples: ``shard_batch``'s (rank, world) of the saved batch of
    two that make up this part's global batch, name)), takes this rank's
    share of them and runs ``dist_step``; saves its record (rank 0's whole,
    the others' without gradients) and the digests of its state."""
    import torch
    from msmdfusion_torch.parallel import dist_scope, shard_batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    manual_env(rank, world, port)
    saved = torch.load(Path(work) / 'step.pt', weights_only=False)
    with dist_scope('manual', 'cuda:0' if backend == 'gloo' else 'cuda',
                    backend) as dev:
        model = build_flagship(dev, caps=scaled_caps(DIST['caps']))
        model.load_state_dict(saved['start'])
        share = shard_batch(shard_batch(saved['batch'], *part['samples']))
        pins = rank_pins(saved['pins'][part['name']], rank, world)
        rec = dist_step(f'dist ({world} rank{"s" if world > 1 else ""}, '
                        f'{backend}) rank {rank}', model, saved['start'],
                        moved(share, dev), card, timed=DIST['timed'],
                        pins=moved(pins, dev))
        rec['digests'] = tensor_digests(rec['state'])
        if rank:
            del rec['grads'], rec['state']
        torch.save(rec, Path(work) / f'rank{rank}.pt')


def dist_steps(card, dev):
    """Phase 18 (a) and (b): the flagship's step over a process group
    against the single-process step on the same batch (see the module
    docstring)."""
    import tempfile
    import torch
    from msmdfusion_torch.parallel import shard_batch
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    from msmdfusion_torch.utils.synth_scene import realistic_batch
    label = 'dist'
    t0 = time.perf_counter()
    model = build_flagship(dev, caps=scaled_caps(DIST['caps']))
    scene = realistic_batch(
        dict(FLAGSHIP['shape'], pcr=model.pts_voxel_layer[
            'point_cloud_range']), b=2, seed=SEED, return_gt=True)
    t = torch.from_numpy
    batch = dict(inputs=(t(scene['points']), t(scene['points_mask']),
                         t(scene['img']),
                         {k: t(v) for k, v in scene['fg'].items()}),
                 gt_bboxes=t(scene['gt']['gt_bboxes']),
                 gt_labels=t(scene['gt']['gt_labels']),
                 gt_valid=t(scene['gt']['gt_valid']))
    whole = moved(batch, dev)
    with torch.no_grad():
        calibrate_norms(model, *whole['inputs'])
    start = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    refs, pins = {}, {}
    for name, b in (('frame 0', shard_batch(whole, 0, 2)),
                    ('batch of 2', whole)):
        ref = dist_step(f'{label}: single process, {name}', model, start, b,
                        card, timed=DIST['timed'] if name == 'frame 0'
                        else 0)
        pins[name] = ref['pins']
        refs[name] = (ref, dist_step(
            f'{label}: single process, {name}, sums reordered', model,
            start, b, card, scopes=[Reordered()],
            pins=moved(rank_pins(pins[name], 0, 1), dev)))
        for rec in refs[name]:
            check(not any(rec['overflow'].values()),
                  f'{label}: the single-process step on the {name} drops '
                  f'rows: {rec["overflow"]}')
    del model, whole
    torch.cuda.empty_cache()
    print(f'{label}: setup and the single-process steps in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    parts = [('(a) world 1, nccl', 1, dict(samples=(0, 2), name='frame 0'),
              'nccl'),
             ('(b) 2 ranks on one card, gloo', 2,
              dict(samples=(0, 1), name='batch of 2'), 'gloo')]
    if torch.cuda.device_count() >= 2:
        parts.append(('(b) 2 ranks on 2 cards, nccl', 2,
                      dict(samples=(0, 1), name='batch of 2'), 'nccl'))
    else:
        print(f'{label}: (b) over nccl on two cards not run: '
              f'{torch.cuda.device_count()} card', flush=True)
    lines = []
    with tempfile.TemporaryDirectory() as work:
        torch.save(dict(start=start, batch=batch, pins=pins),
                   Path(work) / 'step.pt')
        for name, world, part, backend in parts:
            t1 = time.perf_counter()
            for old in Path(work).glob('rank*.pt'):
                old.unlink()
            run_children(step_child, world, (work, part, backend, card),
                         f'{label} {name}')
            ranks = [torch.load(Path(work) / f'rank{r}.pt',
                                weights_only=False) for r in range(world)]
            ref, alt = refs[part['name']]
            run = ranks[0]
            for r, rec in enumerate(ranks):
                check_launches(f'{label} {name}: rank {r}', rec['launches'],
                               TRAIN['launches'])
                check(not any(rec['overflow'].values())
                      and not any(rec['overflow_global'].values()),
                      f'{label} {name}: rank {r} overflow {rec["overflow"]}')
                check(rec['digests'] == run['digests'],
                      f'{label} {name}: rank {r} ends with other tensors '
                      'than rank 0')
                check(rec['metrics'] == run['metrics'],
                      f'{label} {name}: rank {r} metrics differ')
            rows = dist_rows(run, ref, alt, start)
            print(f'{label} {name}: grad_norm {run["metrics"]["grad_norm"]} '
                  f'(reference {ref["metrics"]["grad_norm"]}, sums '
                  f'reordered {alt["metrics"]["grad_norm"]}); its largest '
                  f'parts (name, share of the square, norm here and '
                  f'reordered over the reference\'s): '
                  f'{norm_parts(run, ref, alt)}', flush=True)
            bad = [r for r in rows if r[0] > r[1]]
            check(not bad, f'{label} {name}: over the limit: {bad[:5]}')
            coll = {k: v for k, v in run['collectives'].items() if v}
            lines.append(f'{name}: {worst(rows)}; collectives a step '
                         f'{sum(coll.values())} {coll}; launches a rank '
                         f'{ {k: v for k, v in run["launches"].items() if v} }'
                         f', overflow 0 on {world} '
                         f'rank{"s" if world > 1 else ""} '
                         f'({time.perf_counter() - t1:.1f} s)')
            print(f'{label} {lines[-1]} [{card}]', flush=True)
            if world == 1:
                print(f'{label}: step ms (CUDA events at the seams of '
                      f'make_train_step, {DIST["timed"]} steps each, one '
                      f'card, one call): single process {step_ms(ref)}, '
                      f'world-1 nccl {step_ms(run)} [{card}]', flush=True)
            else:
                print(f'{label}: {name} rank 0 step ms {step_ms(run)} '
                      '(plumbing: two ranks share one card, not a rate) '
                      f'[{card}]', flush=True)
    return lines


def train_cli_child(rank, world, port, argv, out):
    """A rank of phase 18 (d): the train CLI under ``--launcher manual``
    over gloo, the ranks sharing ``cuda:0``; saves its steps, batches and
    the digests of its model's state in the directory ``out``."""
    import torch
    from msmdfusion_torch.tools import train as train_cli
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    manual_env(rank, world, port)
    run = train_cli.main(argv + ['--launcher', 'manual', '--backend', 'gloo',
                                 '--device', 'cuda:0'])
    torch.save(dict(start_step=run['start_step'], step=run['step'],
                    checkpoint=run['checkpoint'], batches=run['batches'],
                    digests=tensor_digests(run['model'].state_dict())),
               Path(out) / f'cli{rank}.pt')


def dist_clis(files):
    """Phase 18 (c) and (d): the eval CLI under torchrun and the train CLI
    over 2 ranks, on phase 17's files (``entry_points``' ``then``)."""
    import os
    import pickle
    import numpy as np
    import torch
    card = files['card']
    label = 'dist'
    lines = []
    t0 = time.perf_counter()
    out = Path(files['out']).with_name('r_2ranks.pkl')
    workers = f'data.workers_per_gpu={DIST["cli_workers"]}'
    proc = subprocess.run(
        ['bash', str(ROOT / 'msmdfusion_torch' / 'tools' / 'dist_test.sh'),
         files['config'], files['checkpoint'], '2', '--backend', 'gloo',
         '--device', 'cuda:0', '--out', str(out), '--cfg-options',
         *files['test_opts'], workers],
        capture_output=True, text=True, timeout=DIST['timeout'],
        env=dict(os.environ, PORT=str(free_port()), PYTHON=sys.executable,
                 PYTHONPATH=str(ROOT)))
    check(proc.returncode == 0, f'{label} (c): dist_test.sh exit '
          f'{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
    with open(files['out'], 'rb') as f:
        one = pickle.load(f)
    with open(out, 'rb') as f:
        two = pickle.load(f)
    check(len(two) == len(one) and all(
        np.array_equal(a[k], b[k]) for a, b in zip(two, one)
        for k in ('bboxes', 'scores', 'labels')),
        f'{label} (c): the 2-rank detections differ from phase 17\'s')
    check('overflow_total 0' in proc.stdout and 'rank 0 of 2' in proc.stdout
          and 'rank 1 of 2' in proc.stdout,
          f'{label} (c): ranks or overflow:\n{proc.stdout[-3000:]}')
    lines.append(f'(c) eval CLI under torchrun, --launcher pytorch, 2 ranks '
                 f'on one card (gloo): {len(two)} samples merged in dataset '
                 'order, each bit-equal to phase 17\'s single-process '
                 f'output; overflow 0 ({time.perf_counter() - t0:.1f} s)')
    print(f'{label} {lines[-1]} [{card}]', flush=True)

    t0 = time.perf_counter()
    work = Path(files['out']).with_name('work_2ranks')
    argv = [files['config'], '--work-dir', str(work), '--cfg-options',
            *files['train_opts'], 'data.samples_per_gpu=1', workers]
    recs = []
    for steps, extra in ((1, []), (2, ['--no-validate'])):
        run_children(train_cli_child, 2,
                     (argv + ['--max-steps', str(steps)] + extra,
                      str(work.parent)), f'{label} (d)')
        recs.append([torch.load(work.parent / f'cli{r}.pt',
                                weights_only=False) for r in range(2)])
        ckpt = torch.load(work / f'ckpt_{steps}', weights_only=True)
        want = tensor_digests(ckpt['state_dict'])
        for r, rec in enumerate(recs[-1]):
            check(rec['step'] == steps and rec['checkpoint'] == str(
                work / f'ckpt_{steps}') and rec['digests'] == want,
                  f'{label} (d): rank {r} after {steps} steps: step '
                  f'{rec["step"]}, checkpoint {rec["checkpoint"]}, its '
                  'tensors equal to the checkpoint\'s: '
                  f'{rec["digests"] == want}')
    names = sorted(p.name for p in work.iterdir())
    logs = [n for n in names if n.endswith('.log.json')]
    check([n for n in names if n not in logs] == [
        'ckpt_1', 'ckpt_2', 'tf_logs', 'train.log'] and len(logs) in (1, 2),
          f'{label} (d): the work dir holds {names}')
    fresh, resumed = recs
    check(all(r['start_step'] == 1 and r['batches'] == f['batches'][:1]
              for f, r in zip(fresh, resumed)),
          f'{label} (d): resumed at {resumed[0]["start_step"]} with batches '
          f'{[r["batches"] for r in resumed]}, the fresh run\'s '
          f'{[r["batches"] for r in fresh]}')
    lines.append(f'(d) train CLI over 2 ranks on one card (gloo): 1 step, '
                 f'ckpt_1 written once (by rank 0), both ranks\' '
                 f'{len(want)} tensors equal to it; resumed at step 1 and '
                 'stepped to 2, ckpt_2 equal to both ranks; batches '
                 f'{[r["batches"] for r in fresh]} then '
                 f'{[r["batches"] for r in resumed]} '
                 f'({time.perf_counter() - t0:.1f} s)')
    print(f'{label} {lines[-1]} [{card}]', flush=True)
    return lines


# phase 19: TransFusion-L's stage-1 recipe from files. Its GT database is
# built by the port's create_data from the frames of ``db_seeds`` (the
# generator of phase 17's frame, other seeds: a database built from the
# frame it trains on offers only boxes that sit on that frame's own GT,
# which the sampler's collision test rejects), written in the nuScenes
# layout under the config's db_sampler.data_root in the working directory,
# where the config reads it. The train CLI runs the config unchanged on
# phase 17's files but for TransFusion-L's encoder capacities times
# ``train_caps`` (the batch's two augmented frames and their pastes); the
# config's own train-time voxel cap drops rows (printed, not held). The
# fade: the CLI's train set with stop_epoch 1, epochs 0 and 1 through one
# loader on ``fade_workers`` worker processes
GT_PASTE = dict(db_seeds=(1, 2, 3), steps=3, train_caps=3, fade_workers=2)
VOXEL_CAP_SITE = 'voxelize.mean_batch.voxel_cap'


def write_db_frames(root, pcr, seeds, shape=FLAGSHIP['shape']):
    """``flagship_frame``'s frames of ``seeds`` in the nuScenes layout under
    ``root`` (samples/LIDAR_TOP, every point in the keyframe, no sweeps) and
    their info file ``nuscenes_infos_train.pkl``; returns the number of GT
    boxes written."""
    import pickle
    import numpy as np
    from msmdfusion_torch.datasets.nuscenes import NuScenesDataset
    from msmdfusion_torch.utils.synth_scene import scene_gt
    root = Path(root).resolve()
    lidar = root / 'samples' / 'LIDAR_TOP'
    lidar.mkdir(parents=True, exist_ok=True)
    infos = []
    for seed in seeds:
        pts, objects = flagship_frame(pcr, shape, seed)
        boxes, labels, valid = scene_gt(objects)
        path = lidar / f'db{seed}.bin'
        pts.tofile(path)
        infos.append(dict(
            token=f'db{seed}', lidar_path=str(path), timestamp=seed,
            sweeps=[], gt_boxes=boxes[valid, :7],
            gt_names=np.array([NuScenesDataset.CLASSES[c]
                               for c in labels[valid]]),
            gt_velocity=boxes[valid, 7:9]))
    with open(root / 'nuscenes_infos_train.pkl', 'wb') as f:
        pickle.dump(dict(infos=infos,
                         metadata=dict(version='v1.0-trainval')), f)
    return sum(len(info['gt_boxes']) for info in infos)


@contextlib.contextmanager
def metas_recorded(module, into):
    """A scope in which ``module.batch_model_inputs`` (a CLI's) appends
    each batch's ``gt_paste`` metas to ``into`` before it runs."""
    orig = module.batch_model_inputs

    def recorded(model_type, batch, device):
        into.append([m['gt_paste'].tolist() for m in batch['metas']
                     if 'gt_paste' in m])
        return orig(model_type, batch, device)
    module.batch_model_inputs = recorded
    try:
        yield
    finally:
        module.batch_model_inputs = orig


def first_batch_pastes(dataset, batch_size, workers, epochs):
    """{epoch: [(objects, points) pasted per sample]} of each epoch's first
    batch of ``dataset``, the epochs in turn through one loader on
    ``workers`` persistent worker processes."""
    from msmdfusion_torch.datasets.loader import DataLoader
    seen = {}
    with DataLoader(dataset, batch_size, seed=SEED,
                    num_workers=workers) as loader:
        for epoch in epochs:
            loader.set_epoch(epoch)
            for batch in loader:
                seen[epoch] = [tuple(m['gt_paste'].tolist())
                               for m in batch['metas']]
                break
    return seen


def gt_paste(card, dev, root, ann, spec=GT_PASTE):
    """Phase 19 (see the module docstring): the port's create_data builds
    the GT database from other frames, the train CLI trains
    TransFusion-L's stage-1 recipe from phase 17's files (``root``,
    ``ann``) with it, and the fade pastes nothing past its epoch."""
    import pickle
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.config import load_config, parse_cli_overrides
    from msmdfusion_torch.registry import DATASETS
    from msmdfusion_torch.tools import create_data
    from msmdfusion_torch.tools import train as train_cli
    from msmdfusion_torch.utils import overflow
    label = 'GT paste'
    config = str(TL['config'])
    cfg = load_config(config)
    sampler = cfg.db_sampler
    t0 = time.perf_counter()
    n_gt = write_db_frames(sampler.data_root, cfg.point_cloud_range,
                           spec['db_seeds'])
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    done = create_data.main(['nuscenes', '--root-path', sampler.data_root,
                             '--with-gt-database'])
    check(Path(done['gt_database']).resolve()
          == Path(sampler.info_path).resolve(),
          f'{label}: create_data wrote {done["gt_database"]}, the config '
          f'reads {sampler.info_path}')
    with open(done['gt_database'], 'rb') as f:
        db = pickle.load(f)
    minimum = sampler.prepare.filter_by_min_points
    usable = {k: sum(e['num_points_in_gt'] >= minimum.get(k, 0) for e in v)
              for k, v in db.items()}
    check(sum(map(len, db.values())) == n_gt and all(usable.values()),
          f'{label}: {n_gt} boxes, database {usable}')
    print(f'{label}: {len(spec["db_seeds"])} frames of seeds '
          f'{list(spec["db_seeds"])} written in {written:.1f} s, their '
          f'{n_gt} GT boxes cropped by create_data --with-gt-database in '
          f'{time.perf_counter() - t0:.1f} s into {done["gt_database"]}; '
          f'clusters the sampler keeps by class {usable}', flush=True)

    # the train CLI: 3 steps and a val frame, the pipeline in its workers
    work = str(Path('work_gt_paste').resolve())
    caps = ','.join(str(c * spec['train_caps']) for c in TL['enc_caps'])
    opts = ([f'model.pts_middle_encoder.stage_capacities={caps}']
            + data_options('train.dataset', root, ann)
            + data_options('val', root, ann)
            + ['evaluation.interval=1', 'evaluation.max_samples=1',
               'log_config.interval=1'])
    pastes = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    with overflow.capture() as cap, metas_recorded(train_cli, pastes):
        run = train_cli.main([config, '--work-dir', work, '--device',
                              str(dev), '--max-steps', str(spec['steps']),
                              '--cfg-options', *opts])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check_launches(f'{label}: train CLI', launches, {
        k: spec['steps'] * v + TL['launches'].get(k, 0)
        for k, v in TL_TRAIN['launches'].items()})
    per_step = {k: (launches[k] - TL['launches'].get(k, 0)) // spec['steps']
                for k in TL_TRAIN['launches']}
    records = json_records(work)
    train = [r for r in records if r['mode'] == 'train']
    val = [r for r in records if r['mode'] == 'val']
    check(len(train) == spec['steps']
          and all(math.isfinite(r['total_loss']) for r in train)
          and len(val) == 1 and 'NDS' in val[0],
          f'{label}: train records {train}, val {val}')
    dropped = {k: v for k, v in cap.counters().items() if v}
    voxel_drop = dropped.pop(VOXEL_CAP_SITE, 0)
    val_dropped = {k: v for k, v in val[0].items()
                   if k.startswith('overflow/') and v}
    check(not dropped and not val_dropped,
          f'{label}: overflow at the port\'s own sites: steps {dropped}, '
          f'val {val_dropped}')
    check(len(pastes) == spec['steps'] and all(
        len(step) == cfg.data.samples_per_gpu and all(
            o > 0 and p > 0 for o, p in step) for step in pastes),
          f'{label}: (objects, points) pasted per sample of each step '
          f'{pastes}')
    print(f'{label}: train CLI on {Path(config).name} (ObjectSample, the '
          f'cyclic schedule, x3) from phase 17\'s files: {spec["steps"]} '
          f'steps + checkpoint + 1 val frame in {seconds:.1f} s; (objects, '
          f'points) pasted per sample of each step {pastes}; total_loss '
          f'{[round(r["total_loss"], 4) for r in train]}, lr '
          f'{[r["lr"] for r in train]}, samples/s '
          f'{[r["samples_per_s"] for r in train]}; launches per step '
          f'{per_step} (+ the val frame\'s {TL["launches"]}); overflow 0 '
          f'at every site of the port\'s own ({spec["train_caps"]}x the '
          f'encoder capacities) in the steps and the val frame; the '
          f'config\'s train-time voxel cap {cfg.model.pts_voxel_layer.max_voxels[0]} '
          f'a sample dropped {voxel_drop} voxels over the {spec["steps"]} '
          f'steps [{card}]', flush=True)
    del run
    torch.cuda.empty_cache()

    # the fade: stop_epoch 1, epochs 0 and 1 through the workers
    t0 = time.perf_counter()
    paste_at = next(i for i, t in enumerate(cfg.data.train.dataset.pipeline)
                    if t['type'] == 'ObjectSample')
    fade = load_config(config, parse_cli_overrides(
        opts + [f'data.train.dataset.pipeline.{paste_at}.stop_epoch=1']))
    seen = first_batch_pastes(DATASETS.build(dict(fade.data.train,
                                                  seed=SEED)),
                              fade.data.samples_per_gpu,
                              spec['fade_workers'], (0, 1))
    check(all(o > 0 for o, _ in seen[0]) and all(
        o == 0 and p == 0 for o, p in seen[1]),
          f'{label}: stop_epoch 1: (objects, points) pasted in the first '
          f'batch of epochs 0 and 1 {seen}')
    print(f'{label}: fade (stop_epoch 1): the first batch of epoch 0 '
          f'pasted {seen[0]}, of epoch 1 {seen[1]} (objects, points per '
          f'sample; one loader, {spec["fade_workers"]} worker processes, '
          f'{time.perf_counter() - t0:.1f} s)', flush=True)


# phase 20: Waymo from files. Phase 16's frame (its 180,000 points and
# GT, seed SEED) as a KITTI-format Waymo set under the configs' data_root in
# the working directory (``write_waymo``): the configs run unchanged but
# for the encoder capacities, ``train_caps`` times WAYMO's for the train
# CLI's batch of two augmented frames, WAYMO's for one eval frame. The
# train infos list the frame so that ``load_interval`` keeps a batch a
# step; ``val`` entries for the eval CLI. The timed pass reads a third
# info file, ``waymo_infos_timed.pkl``, listing the frame ``timed`` times;
# its first ``2 x workers`` frames (start-up and the prefetch) are left
# out, as in phase 17
WAYMO_FILES = dict(steps=2, train_caps=3, val=2, timed=40)


def waymo_calib():
    """A KITTI calibration that is not the identity: Tr_velo_to_cam the
    LiDAR-to-camera axes after a 0.02 rad yaw and an offset, R0_rect a
    0.01 rad roll, P2 a 700-pixel pinhole."""
    import numpy as np
    c, s = np.cos(0.02), np.sin(0.02)
    tr = np.eye(4)
    tr[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]]) @ np.array(
        [[c, -s, 0], [s, c, 0], [0, 0, 1]])
    tr[:3, 3] = [0.05, -0.3, 0.1]
    c, s = np.cos(0.01), np.sin(0.01)
    r0 = np.eye(4)
    r0[1:3, 1:3] = [[c, -s], [s, c]]
    p2 = np.array([[700.0, 0, 600, 0], [0, 700, 200, 0], [0, 0, 1, 0]])
    return dict(R0_rect=r0.astype(np.float32),
                Tr_velo_to_cam=tr.astype(np.float32),
                P2=p2.astype(np.float32))


def write_waymo(root, frames, counts, classes, image_shape=(1280, 1920),
                prefix='waymo', columns=6):
    """A KITTI-format Waymo set under ``root``: each of ``frames`` (points
    [N, 5], LiDAR boxes [G, 7], labels [G]) as a 6-float velodyne ``.bin``
    (a zero column added; with ``columns=4`` a KITTI one, xyz and
    intensity), and for each split of ``counts`` ({split: entries}) the
    info file ``<prefix>_infos_<split>.pkl``, whose k-th entry
    is frame k mod len(frames): image (image_idx, image_shape),
    point_cloud (velodyne_path, lidar_idx), ``waymo_calib()``, the GT as
    camera-frame annos (location, dimensions (l, h, w), rotation_y, the
    P2 box, alpha, num_points_in_gt) with a DontCare entry, context_name
    and timestamp. Returns {split: info path}."""
    import pickle
    import numpy as np
    from msmdfusion_torch.core import box_modes
    from msmdfusion_torch.core.box_np_ops import (box_lidar_to_camera,
                                                  points_in_rbbox_np)
    root = Path(root)
    (root / 'velodyne').mkdir(parents=True, exist_ok=True)
    calib = waymo_calib()
    annos = []
    for i, (pts, boxes, labels) in enumerate(frames):
        cols = (pts[:, :4] if columns == 4 else np.concatenate(
            [pts[:, :5], np.zeros((len(pts), 1), pts.dtype)], 1))
        cols.astype(np.float32).tofile(root / 'velodyne' / f'{i:06d}.bin')
        cam = box_lidar_to_camera(boxes[:, :7].astype(np.float64),
                                  calib['R0_rect'].astype(np.float64),
                                  calib['Tr_velo_to_cam'].astype(np.float64))
        corners = box_modes.cam_corners_3d(cam)
        hom = np.concatenate([corners, np.ones(corners.shape[:2] + (1,))], -1)
        proj = hom @ calib['P2'].astype(np.float64).T
        pix = proj[..., :2] / np.maximum(proj[..., 2:3], 1e-6)
        bbox = np.clip(np.concatenate([pix.min(1), pix.max(1)], 1), 0,
                       [image_shape[1], image_shape[0]] * 2)
        n = len(boxes)
        dont_care = dict(name='DontCare', truncated=-1.0, occluded=-1,
                         alpha=-10.0, bbox=[0.0, 0.0, 10.0, 10.0],
                         dimensions=[-1.0, -1.0, -1.0],
                         location=[-1000.0, -1000.0, -1000.0],
                         rotation_y=-10.0, num_points_in_gt=-1)
        annos.append(dict(
            name=np.array([classes[int(k)] for k in labels]
                          + [dont_care['name']]),
            truncated=np.append(np.zeros(n), dont_care['truncated']),
            occluded=np.append(np.zeros(n, np.int64),
                               dont_care['occluded']),
            alpha=np.append(-np.arctan2(-boxes[:, 1], boxes[:, 0])
                            + cam[:, 6], dont_care['alpha']),
            bbox=np.concatenate([bbox, [dont_care['bbox']]]),
            dimensions=np.concatenate([cam[:, 3:6],
                                       [dont_care['dimensions']]]),
            location=np.concatenate([cam[:, :3], [dont_care['location']]]),
            rotation_y=np.append(cam[:, 6], dont_care['rotation_y']),
            num_points_in_gt=np.append(
                points_in_rbbox_np(pts[:, :3], boxes).sum(0),
                dont_care['num_points_in_gt']).astype(np.int64)))
    paths = {}
    for split, count in counts.items():
        infos = []
        for k in range(count):
            i = k % len(frames)
            infos.append(dict(
                image=dict(image_idx=k, image_shape=np.array(image_shape)),
                point_cloud=dict(num_features=columns, lidar_idx=f'{i:07d}',
                                 velodyne_path=f'velodyne/{i:06d}.bin'),
                calib=dict(calib), annos=annos[i],
                context_name=f'segment-{i}', timestamp=1_500_000_000 + k))
        paths[split] = root / f'{prefix}_infos_{split}.pkl'
        with open(paths[split], 'wb') as f:
            pickle.dump(infos, f)
    return paths


def waymo_files(card, dev, spec=WAYMO_FILES):
    """Phase 20 (see the module docstring): the train and eval CLIs on
    ``write_waymo``'s files of phase 16's frame under
    ``configs/transfusion_waymo_voxel_{L,LC}.py``."""
    import tempfile
    import numpy as np
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.inference import (batch_model_inputs,
                                                 unpack_detections)
    from msmdfusion_torch.config import load_config, parse_cli_overrides
    from msmdfusion_torch.core.evaluation.waymo_serialize import \
        parse_objects_bin
    from msmdfusion_torch.datasets.loader import DataLoader
    from msmdfusion_torch.models.builder import build_detector
    from msmdfusion_torch.registry import DATASETS
    from msmdfusion_torch.tools import test as test_cli
    from msmdfusion_torch.tools import train as train_cli
    from msmdfusion_torch.utils import overflow
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    from msmdfusion_torch.utils.checkpoint import save_checkpoint
    from msmdfusion_torch.utils.synth_scene import LC_YAWS, lc_batch
    label = 'Waymo files'
    config, config_lc = str(WAYMO['config']), str(WAYMO['config_lc'])
    cfg = load_config(config)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        batch = lc_batch(dict(n=WAYMO['n_points'], img_hw=(8, 8),
                              yaws=LC_YAWS[WAYMO['dataset']],
                              pcr=cfg.point_cloud_range), seed=SEED,
                         return_gt=True, num_classes=len(cfg.class_names),
                         box_dim=7)
        gt = batch['gt']
        valid = gt['gt_valid'][0]
        frame = (batch['points'][0], gt['gt_bboxes'][0][valid],
                 gt['gt_labels'][0][valid])
        del batch
        train_cfg = cfg.data.train
        n_train = (spec['steps'] * cfg.data.samples_per_gpu
                   * train_cfg.load_interval)
        paths = write_waymo(cfg.data_root, [frame],
                            dict(train=n_train, val=spec['val'],
                                 timed=spec['timed']), cfg.class_names)
        check(paths['train'] == Path(train_cfg.ann_file)
              and paths['val'] == Path(cfg.data.test.ann_file),
              f'{label}: wrote {paths}, the config reads '
              f'{train_cfg.ann_file} and {cfg.data.test.ann_file}')
        print(f'{label}: phase 16\'s {len(frame[0])}-point frame and its '
              f'{len(frame[1])} boxes as a KITTI-format Waymo set under '
              f'{cfg.data_root} ({n_train} train infos, load_interval '
              f'{train_cfg.load_interval}; {spec["val"]} val infos; a '
              f'calibration that is not the identity) in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)

        # the train CLI, the config's recipe, its pipeline in the workers
        caps = ','.join(str(c * spec['train_caps'])
                        for c in WAYMO['enc_caps'])
        work = str(Path('work_waymo').resolve())
        kernels.reset_launches()
        t0 = time.perf_counter()
        with overflow.capture() as cap:
            run = train_cli.main([
                config, '--work-dir', work, '--device', str(dev),
                '--max-steps', str(spec['steps']), '--cfg-options',
                f'model.pts_middle_encoder.stage_capacities={caps}',
                'log_config.interval=1'])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_launches(f'{label}: train CLI', dict(kernels.launches),
                       {k: spec['steps'] * v
                        for k, v in TL_TRAIN['launches'].items()})
        train = [r for r in json_records(work) if r['mode'] == 'train']
        dropped = {k: v for k, v in cap.counters().items() if v}
        check(len(train) == spec['steps'] and len(run['batches'])
              == spec['steps'] and all(math.isfinite(r['total_loss'])
                                       for r in train) and not dropped,
              f'{label}: train CLI records {train}, overflow {dropped}')
        print(f'{label}: train CLI on {Path(config).name} (no paste in its '
              f'recipe): {spec["steps"]} steps + checkpoint in '
              f'{seconds:.1f} s over the {n_train // train_cfg.load_interval}'
              f' infos load_interval keeps; batches {run["batches"]} (image '
              f'indices); total_loss '
              f'{[round(r["total_loss"], 4) for r in train]}; launches '
              f'{TL_TRAIN["launches"]} a step; overflow 0 at every site '
              f'({spec["train_caps"]}x the encoder capacities, the '
              f'config\'s voxel capacity) [{card}]', flush=True)
        del run
        torch.cuda.empty_cache()

        # a checkpoint: the seed's weights, norms calibrated on val frame 0
        test_opts = ['model.pts_middle_encoder.stage_capacities='
                     + ','.join(map(str, WAYMO['enc_caps']))]
        cfg_t = load_config(config, parse_cli_overrides(test_opts))
        dataset = DATASETS.build(dict(cfg_t.data.test))
        model = build_detector(cfg_t.model, device=dev, seed=SEED)
        with DataLoader(dataset, 1, shuffle=False, drop_last=False,
                        num_workers=0, device=dev) as loader:
            inputs = batch_model_inputs(cfg_t.model.type, next(iter(loader)),
                                        dev)
        with torch.no_grad():
            calibrate_norms(model, *inputs)
        ckpt = save_checkpoint(str(Path('ckpt_l').resolve()), 0, model,
                               meta=dict(config=config))
        lc = build_detector(load_config(
            config_lc, parse_cli_overrides(test_opts)).model, device=dev,
            seed=SEED)
        missing, unexpected = lc.load_state_dict(model.state_dict(),
                                                 strict=False)
        check(missing and not unexpected, f'{label}: the LC model lacks '
              f'{unexpected[:4]} of TransFusion-L\'s keys')
        ckpt_lc = save_checkpoint(str(Path('ckpt_lc').resolve()), 0, lc,
                                  meta=dict(config=config_lc))
        del model, lc

        # the eval CLI, --eval: the dataset's waymo metrics
        kernels.reset_launches()
        run = test_cli.main([config, ckpt, '--eval', 'waymo', '--device',
                             str(dev), '--cfg-options', *test_opts])
        torch.cuda.synchronize()
        n = len(run['results'])
        check(n == spec['val'], f'{label}: {n} results')
        check_launches(f'{label}: eval CLI', dict(kernels.launches),
                       {k: v * n for k, v in TL['launches'].items()})
        metrics = run['metrics']
        numbers = {k: v for k, v in metrics.items() if k != 'protocol'}
        check(sum(run['overflow'].values()) == 0
              and 'Waymo/L2/mAP' in numbers and all(
                  math.isfinite(v) for v in numbers.values()),
              f'{label}: eval CLI overflow {run["overflow"]}, metrics '
              f'{metrics}')
        model = run['model']
        with torch.no_grad():
            direct = unpack_detections(model.get_bboxes(model(*inputs)))[0]
        for key in ('bboxes', 'scores', 'labels'):
            check(np.array_equal(run['results'][0][key], direct[key]),
                  f'{label}: sample 0 {key} differ from the direct call')
        for det in run['results']:
            check(np.isfinite(det['bboxes']).all()
                  and det['bboxes'].shape[1] == 7, f'{label}: boxes')
        results = run['results']
        print(f'{label}: eval CLI --eval: {n} frames; sample 0\'s '
              f'{len(direct["scores"])} detections bit-equal to '
              'model.get_bboxes(model(...)) on the same batch; launches '
              f'{TL["launches"]} a frame; overflow 0; waymo metrics '
              f'L1 mAP {numbers["Waymo/L1/mAP"]} mAPH '
              f'{numbers["Waymo/L1/mAPH"]} L2 mAP {numbers["Waymo/L2/mAP"]}'
              f' mAPH {numbers["Waymo/L2/mAPH"]} (seed weights: no '
              f'meaning) [{card}]', flush=True)
        with torch.no_grad():
            frame_ms = cuda_ms(lambda: forward(model, inputs), 5)
        del run, model, inputs

        # the timed pass: the eval CLI over the frame listed spec['timed']
        # times, and the pipeline alone on the same entries
        workers = cfg_t.data.workers_per_gpu
        run = test_cli.main([config, ckpt, '--device', str(dev),
                             '--cfg-options', *test_opts,
                             f'data.test.ann_file={paths["timed"]}'])
        check(len(run['results']) == spec['timed']
              and not sum(run['overflow'].values()),
              f'{label}: timed pass {len(run["results"])} results, overflow '
              f'{run["overflow"]}')
        cli_ms = steady_ms(run['frame_s'], 2 * workers)
        timed = run['dataset']
        del run
        many = pipeline_ms(timed, workers, spec['timed'])
        print(f'{label}: timed pass, {spec["timed"]} frames: eval CLI '
              f'{1e3 / cli_ms:.3f} frames/s ({cli_ms:.1f} ms/frame from '
              f'frame {2 * workers} on, host clock); pipeline alone '
              f'{many:.1f} ms/sample with {workers} workers (from sample '
              f'{2 * workers}); model {frame_ms:.3f} ms/frame (CUDA events, '
              f'5 frames of sample 0) [{card}]', flush=True)
        del timed

        run = test_cli.main([config, ckpt, '--format-only', '--device',
                             str(dev), '--cfg-options', *test_opts])
        with open(run['submission'], 'rb') as f:
            objs = parse_objects_bin(f.read())
        detected = sum(len(r['scores']) for r in run['results'])
        check(len(objs) == detected and detected > 0 and {
            o['context_name'] for o in objs} <= {'segment-0'},
              f'{label}: {run["submission"]} parses to {len(objs)} objects '
              f'of {detected} detections')
        print(f'{label}: --format-only: {run["submission"]} parses back '
              f'(parse_objects_bin) to {len(objs)} objects, the '
              f'{detected} detections', flush=True)
        del run

        # TransFusion-LC from files: no views in its pipeline, so its
        # detections are TransFusion-L's on the same weights
        run = test_cli.main([config_lc, ckpt_lc, '--device', str(dev),
                             '--cfg-options', *test_opts])
        check(len(run['results']) == n and all(
            np.array_equal(a[k], b[k]) for a, b in zip(run['results'],
                                                        results)
            for k in ('bboxes', 'scores', 'labels')),
              f'{label}: TransFusion-LC\'s detections differ from '
              'TransFusion-L\'s')
        print(f'{label}: eval CLI on {Path(config_lc).name} (its pipeline '
              f'loads no views): {n} frames\' detections bit-equal to '
              f'TransFusion-L\'s on the same weights [{card}]', flush=True)
        del run
    torch.cuda.empty_cache()


# phase 21: how far the trace's device total may lie from
# profile_forward's busy time of another frame
TRACE_TOL = 0.10


def kept(model, inputs):
    """A model's weights on the host and its frame's inputs, for phase 21
    (later phases train the model; phase 3's ``keep_tl`` keeps its weights
    on the card)."""
    return dict(state={k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()},
                inputs=inputs)


def flop_counts(label, model, inputs, card):
    """Phase 21 (a): ``count_flops`` of one frame on the kernels and on
    their plain versions (the same integers, op by op), the sparse convs'
    share and the fp32 frame's TFLOP/s."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.flops_counter import count_flops
    with torch.no_grad():
        kernels.reset_launches()
        got = count_flops(lambda: forward(model, inputs))
        check(sum(kernels.launches.values()) > 0,
              f'{label}: the counted frame launched no kernel')
        with kernels.plain_kernels():
            plain = count_flops(lambda: forward(model, inputs))
        ms = cuda_ms(lambda: forward(model, inputs), 5)
    check(got['flops'] == plain['flops'] and got['by_op'] == plain['by_op'],
          f'{label}: count_flops on the kernels {got["by_op"]} differs from '
          f'the plain versions\' {plain["by_op"]}')
    convs = sum(v for k, v in got['by_op'].items()
                if k in ('gather_gemm_conv', 'match_conv', 'conv_dw'))
    top = sorted(got['by_op'].items(), key=lambda kv: -kv[1])[:6]
    print(f'{label}: count_flops {int(got["flops"])} FLOP = '
          f'{got["gflops"]:.3f} GFLOP/frame, the same integers on the '
          f'kernels and on the plain versions; sparse convs '
          f'{convs / got["flops"]:.4f} of it, all sparse ops '
          f'{got["sparse_flops"] / got["flops"]:.4f}; by op '
          f'{dict((k, round(v / 1e9, 3)) for k, v in top)} GFLOP; fp32 '
          f'frame {ms:.3f} ms (CUDA events, 5 frames): '
          f'{got["flops"] / ms / 1e9:.3f} TFLOP/s [{card}]', flush=True)


def fused_frame(model, inputs, card, dev, work):
    """Phase 21 (b): ``tools.misc.fuse_conv_bn`` on ``model``'s weights
    saved as a checkpoint; a kernel-path frame of the fused model against
    ``model``'s on the exact product (``MSMD_CONV_GEMM=highest``, set
    around it), where the fold changes roundings alone: the head input
    within TOL of max, the proposals the head's own choice on a heatmap
    within TOL of the unfused one's (``check_proposals``). The same on the
    default x3 product is printed, not held: the fold moves every folded
    weight's bf16 hi/lo split."""
    import torch
    from msmdfusion_torch.tools.misc import fuse_conv_bn
    from msmdfusion_torch.utils.checkpoint import save_checkpoint
    ckpt = save_checkpoint(work, 0, model, meta=dict(config='flagship'))
    out = str(Path(work) / 'fused.pth')
    run = fuse_conv_bn.main([str(FLAGSHIP['config']), ckpt, out, '--device',
                             str(dev), '--cfg-options',
                             *capacity_options(FLAGSHIP)])
    check(run['fused'] == FUSED_PAIRS,
          f'fuse_conv_bn folded {run["fused"]} pairs, the CPU test '
          f'{FUSED_PAIRS}')
    fused = run['model']
    frames = {}
    for route, env in (('x3', {}), ('highest', HIGHEST['env'])):
        with switches(env), torch.no_grad():
            ref = pinned_forward(model, inputs, None)
            index = proposal_index(forward(fused, inputs)[0])
            got = pinned_forward(fused, inputs, index)
        own = proposal_index(ref)
        differ = int((~(index[:, :, None] == own[:, None, :])
                      .any(-1)).sum())
        head = rel_err(got['head_input'], ref['head_input'])
        heat = rel_err(got['dense_heatmap'], ref['dense_heatmap'])[1]
        frames[route] = (ref, index, got, head)
        print(f'fuse_conv_bn: {run["fused"]} conv+bn pairs folded (the CPU '
              f'test\'s {FUSED_PAIRS}); the fused kernel-path frame against '
              f'the unfused one on {route}: head input {head[0]:.4g} '
              f'({head[1]:.4g} of max), dense heatmap {heat:.4g} of max, '
              f'{differ} of {index.numel()} proposals differ from the '
              f'unfused frame\'s own [{card}]', flush=True)
    ref, index, got, head = frames['highest']
    check(head[1] <= TOL, f'fused frame on highest: head input '
          f'{head[1]:.3g} of max from the unfused one, above {TOL}')
    with switches(HIGHEST['env']):
        dist, excess, suppressed, _ = check_proposals(
            fused.pts_bbox_head, index, got, ref)
    print(f'fuse_conv_bn on highest: the fused frame\'s proposals are the '
          f'head\'s own choice on a heatmap {dist:.4g} of max from the '
          f'unfused one (best unchosen beats the lowest chosen by '
          f'{excess:.3g}, {suppressed} chosen cells suppressed there) '
          f'[{card}]', flush=True)
    del fused, run
    torch.cuda.empty_cache()


def microbench(card, dev):
    """Phase 21 (c): ``conv_microbench`` at full shapes, every config;
    each conv's minimum at or above its bound."""
    from msmdfusion_torch.tools.analysis_tools import conv_microbench
    reps = conv_microbench.REPS
    out = conv_microbench.run(
        {'rows', 'conv', 'onehot', 'coords', 'glue'}, device=dev)
    check(len(out['convs']) == len(conv_microbench.CONFIGS),
          f'conv_microbench: {len(out["convs"])} configs')
    for rec in out['convs']:
        for op in ('conv', 'onehot'):
            check(rec[op][0] >= rec[f'{op}_bound'],
                  f'conv_microbench {rec["name"]} {rec[f"{op}_kernel"]}: '
                  f'{rec[op][0]:.4f} ms below its bound '
                  f'{rec[f"{op}_bound"]:.4f}')
    print(f'conv_microbench: {len(out["convs"])} configs, min/median of '
          f'{reps} calls, every conv at or above its bound [{card}]',
          flush=True)


def speed_cli(card, dev, n=200000):
    """Phase 21 (d): the speed CLI on TransFusion-L at ``n`` points."""
    import numpy as np
    from msmdfusion_torch.tools.analysis_tools import benchmark
    run = benchmark.main([str(TL['config']), '--num-points', str(n),
                          '--device', str(dev)])
    arr = np.asarray(run['times'])
    check(len(arr) == 50 and np.isfinite(arr).all(),
          f'benchmark: {len(arr)} timed frames')
    print(f'benchmark {TL["config"].name} at {n} uniform points: '
          f'{1 / np.median(arr):.2f} frames/s median, latency median '
          f'{np.median(arr) * 1e3:.1f} ms, overflow_total '
          f'{sum(run["overflow"].values())} [{card}]', flush=True)


def traced_frame(model, inputs, card, dev, work):
    """Phase 21 (e): a flagship frame under ``utils.profiling.trace``,
    summarized by ``trace_summary``; its device total within TRACE_TOL of
    ``profile_forward``'s busy ms of a frame."""
    import torch
    from msmdfusion_torch.tools.analysis_tools import trace_summary
    from msmdfusion_torch.utils import profiling
    with torch.no_grad():
        forward(model, inputs)
        _, busy, _ = profile_forward(lambda: forward(model, inputs))
        with profiling.trace(str(Path(work) / 'trace')):
            forward(model, inputs)
    out = trace_summary.main([str(Path(work) / 'trace'), '-n', '12',
                              '--device', str(dev)])
    off = abs(out['total_ms'] - busy) / busy
    check(out['iters'] == 1 and off <= TRACE_TOL,
          f'trace_summary: {out["iters"]} iters, device total '
          f'{out["total_ms"]:.3f} ms against profile_forward\'s busy '
          f'{busy:.3f} ms ({off:.3f} apart, limit {TRACE_TOL})')
    print(f'trace_summary: device total {out["total_ms"]:.3f} ms a frame '
          f'against profile_forward\'s busy {busy:.3f} ms ({off:.4f} apart);'
          f' {len(out["ops"])} kernels by name; scopes '
          f'{dict((k, round(v, 3)) for k, v in sorted(out["scopes"].items(), key=lambda kv: -kv[1])[:6])} ms'
          f' [{card}]', flush=True)


def offline_tools(card, dev, flag, tl):
    """Phase 21 (a)-(e) on phase 4's flagship and phase 3's TransFusion-L
    (``kept``)."""
    import tempfile
    import torch
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        tl_model = build_model(dev, max_voxels=TL['max_voxels'])
        tl_model.load_state_dict(tl['state'])
        flop_counts('TransFusion-L', tl_model, tl['inputs'], card)
        del tl_model
        model = build_flagship(dev)
        model.load_state_dict(flag['state'])
        flop_counts('MSMDFusion', model, flag['inputs'], card)
        print(f'phase 21 (a): {time.perf_counter() - t0:.1f} s', flush=True)
        fused_frame(model, flag['inputs'], card, dev, work)
        traced_frame(model, flag['inputs'], card, dev, work)
        del model
        torch.cuda.empty_cache()
        microbench(card, dev)
        speed_cli(card, dev)
    torch.cuda.empty_cache()


def tool_files(card, dev, files):
    """Phase 21 (f), on phase 17's files: ``publish_model`` on the train
    CLI's last checkpoint (no optimizer; every tensor equal to the
    checkpoint's), ``visualize_results`` on the eval CLI's ``--out``
    pickle, ``analyze_logs`` on the train CLI's logs."""
    import importlib.util
    import io
    import torch
    from msmdfusion_torch.tools.analysis_tools import analyze_logs
    from msmdfusion_torch.tools.misc import visualize_results
    from msmdfusion_torch.tools.model_converters import publish_model
    from msmdfusion_torch.utils.checkpoint import load_checkpoint
    work = Path(files['work'])
    ckpt = str(max(work.glob('ckpt_*'),
                   key=lambda p: int(p.name.split('_')[1])))
    source = load_checkpoint(ckpt)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        path = publish_model.main([ckpt, str(work / 'published'), '--device',
                                   str(dev)])
    published = load_checkpoint(path)
    check(text.getvalue().strip() == path and 'optimizer' in source
          and 'optimizer' not in published
          and set(published['state_dict']) == set(source['state_dict'])
          and all(torch.equal(v, source['state_dict'][k])
                  for k, v in published['state_dict'].items()),
          f'publish_model: {path}')
    print(f'publish_model: {Path(ckpt).name} -> {Path(path).name} '
          f'({Path(path).stat().st_size} bytes, from '
          f'{Path(ckpt).stat().st_size}): no optimizer, '
          f'{len(published["state_dict"])} tensors equal [{card}]',
          flush=True)
    show = work / 'show'
    written = visualize_results.main([
        files['config'], '--result', files['out'], '--show-dir', str(show),
        '--device', str(dev), '--cfg-options', *files['test_opts']])
    kinds = sorted({Path(f).suffix for f in written})
    # the BEV PNG needs matplotlib, which the card's machine may lack
    drawn = importlib.util.find_spec('matplotlib') is not None
    check(kinds == ['.html', '.obj'] + (['.png'] if drawn else [])
          and all(Path(f).stat().st_size > 0 for f in written),
          f'visualize_results wrote {written}')
    print(f'visualize_results: {len(written)} files {kinds} '
          f'({sum(Path(f).stat().st_size for f in written)} bytes'
          + ('' if drawn else '; no PNG: matplotlib is not installed')
          + f') [{card}]', flush=True)
    logs = [str(work / 'train.log')] + sorted(
        str(p) for p in work.glob('*.log.json'))
    with contextlib.redirect_stdout(io.StringIO()) as text:
        analyze_logs.main(logs + ['--keys', 'total_loss', 'grad_norm',
                                  '--device', str(dev)])
    summary = text.getvalue()
    check(summary.count(' entries, mean throughput ') == len(logs)
          and summary.count('total_loss: first') == len(logs),
          f'analyze_logs: {summary}')
    print(summary.rstrip(), flush=True)
    print(f'analyze_logs: {len(logs)} logs summarized [{card}]', flush=True)


# phase 22: the single-stage LiDAR zoo at its configs' own widths and
# capacities (no stage capacity set: each downsample keeps its input's),
# batch 1, seed-0 weights, norms calibrated on the frame. (a) CenterPoint
# and (b) PointPillars on phase 3's 250,000-point frame, (c) SECOND and (d)
# DynamicVoxelNet on a 40,000-point KITTI-range frame (second_kitti.py's
# max_points_per_sample), (e) FreeAnchor on (b)'s frame. Launches: the
# sparse encoder's plans and convs (CenterPoint's is TransFusion-L's;
# SECOND's conv_module encoder: 4 submanifold and 4 strided plans, 12
# convs; a step adds the 4 strided convs' dual plans, the input gradient
# of every conv but conv_input and every conv's dw); the pillar and
# anchor paths launch none
ZOO = dict(
    centerpoint=dict(config=ROOT / 'configs' / 'centerpoint_nusc_voxel.py',
                     launches=TL['launches'],
                     train=TL_TRAIN['launches']),
    pointpillars=dict(config=ROOT / 'configs' / 'pointpillars_nusc.py',
                      launches={}, train={}),
    second=dict(config=ROOT / 'configs' / 'second_kitti.py',
                launches={'rows_affine': 8, 'gather_gemm_conv_x3': 12},
                train={'rows_affine': 8, 'rows_queries': 4,
                       'gather_gemm_conv_x3': 23, 'conv_dw_x3': 12}),
    dynamic=dict(config=ROOT / 'configs' / 'dynamic_voxelnet_kitti.py',
                 launches={'rows_affine': 8, 'gather_gemm_conv_x3': 12}),
    free_anchor=dict(config=ROOT / 'configs' / 'free_anchor_nusc.py',
                     train={}),
    n_points=TL['n_points'], kitti_points=40000, frames=10, steps=3,
    steps_per_epoch=1000)
# a pair of candidates whose IoU or squared centre distance lies this near
# its NMS threshold (relative, at least 1) may flip between two devices'
# rounding: such pairs are counted and printed, not held
NMS_NEAR = 1e-6


def zoo_model(config, dev):
    """The detector of ``config`` at its own widths and capacities, seed-0
    weights."""
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.models.builder import build_detector
    import msmdfusion_torch.models  # noqa: F401
    return build_detector(load_config(str(config)).model, device=dev,
                          seed=SEED)


def detection_head(model):
    """The head that decodes a model's boxes from the BEV map: its
    ``pts_bbox_head``, or a two-stage model's RPN."""
    head = getattr(model, 'pts_bbox_head', None)
    return head if head is not None else model.rpn_head


def kitti_frame(model, n_points, device):
    """A ``synth_scene.lidar_scene`` frame over the model's (KITTI) range:
    points [1, N, 4] (xyz, intensity), mask, and the ground truth (7-wide
    boxes, labels below the head's classes)."""
    (points, mask), (boxes, labels, valid) = make_points(model, n_points,
                                                         device)
    classes = detection_head(model).num_classes
    return ((points[..., :4].contiguous(), mask),
            (boxes[..., :7].contiguous(), labels % classes, valid))


class NmsCalls:
    """Keep every NMS call of the zoo's heads made inside the scope: (the
    function, its arguments, its result)."""
    SITES = (('centerpoint_head', 'circle_nms'),
             ('anchor3d_head', 'box3d_multiclass_nms'))

    def __enter__(self):
        import importlib
        self.calls, self._orig = [], []
        for mod, name in self.SITES:
            module = importlib.import_module(
                f'msmdfusion_torch.models.heads.{mod}')
            fn = getattr(module, name)
            self._orig.append((module, name, fn))

            def kept(*args, _fn=fn, **kwargs):
                out = _fn(*args, **kwargs)
                self.calls.append((_fn, args, kwargs, out))
                return out
            setattr(module, name, kept)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._orig:
            setattr(module, name, fn)
        return False


def near_pairs(fn, args, kwargs):
    """Pairs of candidates (both valid) whose squared centre distance or
    BEV IoU lies within ``NMS_NEAR`` of the call's threshold."""
    import torch
    from msmdfusion_torch.core.iou3d import boxes_iou_bev
    if fn.__name__ == 'circle_nms':
        ctr, radius = args[0], args[2]
        valid = kwargs.get('valid')
        d = ctr[..., :, None, :] - ctr[..., None, :, :]
        value, thr = (d * d).sum(-1), radius * radius
        both = valid[..., :, None] & valid[..., None, :]
    else:
        bev, thr = args[1], args[4]
        value = boxes_iou_bev(bev, bev)
        both = torch.ones_like(value, dtype=torch.bool)
    n = value.shape[-1]
    upper = torch.ones(n, n, dtype=torch.bool, device=value.device).triu(1)
    near = ((value - thr).abs() <= NMS_NEAR * max(1.0, abs(thr))) & both
    return int((near & upper).sum())


def nms_check(label, calls):
    """Each NMS call of the card's path run again on the CPU on the same
    inputs: the same keep set and order, unless a pair lies near its
    threshold (counted and printed)."""
    import torch
    same, near_total = 0, 0
    for fn, args, kwargs, out in calls:
        def cpu(x):
            return x.cpu() if torch.is_tensor(x) else x
        want = fn(*map(cpu, args), **{k: cpu(v) for k, v in kwargs.items()})
        got = out if isinstance(out, dict) else dict(enumerate(out))
        want = want if isinstance(want, dict) else dict(enumerate(want))
        equal = all(torch.equal(got[k].cpu(), want[k]) for k in want)
        near = near_pairs(fn, args, kwargs)
        near_total += near
        check(equal or near > 0, f'{label}: {fn.__name__} on the card keeps '
              'another set or order than on the CPU, no pair near its '
              'threshold')
        same += equal
    print(f'{label}: NMS on the card against the CPU on the same inputs: '
          f'{same} of {len(calls)} calls keep the same set and order; '
          f'{near_total} pairs within {NMS_NEAR:g} of their threshold '
          '(counted, not held)', flush=True)
    return same, near_total


class PinnedTopK:
    """Inside the scope the zoo's top-K choices (``topk_lower_index`` in
    the CenterPoint coder and the anchor heads' decode) keep, in call
    order, the indices ``index`` gives (each call's own where ``index`` is
    None; ``self.index`` then holds them): two paths then decode the same
    cells or anchors."""

    SITES = ('msmdfusion_torch.core.coders',
             'msmdfusion_torch.models.heads.anchor3d_head',
             'msmdfusion_torch.models.detectors.parta2')

    def __init__(self, index=None):
        self.replay = index is not None
        self.index = list(index or ())
        self.calls = 0

    def __enter__(self):
        import importlib
        import torch
        self._orig = []
        for site in self.SITES:
            module = importlib.import_module(site)
            fn = module.topk_lower_index
            self._orig.append((module, fn))

            def pinned(x, k, _fn=fn):
                if self.replay:
                    idx = self.index[self.calls]
                    self.calls += 1
                    return torch.gather(x, -1, idx), idx
                values, idx = _fn(x, k)
                self.index.append(idx)
                return values, idx
            module.topk_lower_index = pinned
        return self

    def __exit__(self, *exc):
        for module, fn in self._orig:
            module.topk_lower_index = fn
        return False


def zoo_preds(preds, prefix=''):
    """The head's outputs as one flat {name: tensor} dict (a list of task
    dicts, or Part-A2's nested 'rpn'/'roi'/'semantic' dicts)."""
    if isinstance(preds, list):
        return {f'{prefix}task{t}.{k}': v for t, p in enumerate(preds)
                for k, v in p.items()}
    out = {}
    for k, v in preds.items():
        if isinstance(v, dict):
            out.update(zoo_preds(v, f'{prefix}{k}.'))
        else:
            out[prefix + k] = v
    return out


def zoo_outputs(model, inputs, index, *scopes, rois=None):
    """(head input, head outputs, the NMS calls' candidates) of one
    forward and decode, its top K pinned to ``index`` (its own where
    None), the top K it took, and the RoIs Part-A2's RoI head took
    (``rois``, a list of each call's, where given: the RoI-aware pooling
    puts each voxel centre in a cell of its RoI, and a RoI moved by the
    rounding moves the centres on a cell's face to the next cell)."""
    import torch
    kept = [] if rois is None else list(rois)
    with contextlib.ExitStack() as stack, torch.no_grad():
        for scope in scopes:
            stack.enter_context(scope)
        top = stack.enter_context(PinnedTopK(index))
        head_in = stack.enter_context(HeadInput(detection_head(model)))
        nms = stack.enter_context(NmsCalls())
        unet = {}
        if hasattr(model, 'middle_encoder'):          # Part-A2's U-Net
            stack.callback(model.middle_encoder.register_forward_hook(
                lambda m, a, out: unet.update(x=out[1].features.clone())
            ).remove)
            calls = [0]

            def pin(module, args, kwargs):
                if rois is None:
                    kept.append(args[3].clone())
                    return None
                args = args[:3] + (kept[calls[0]],) + args[4:]
                calls[0] += 1
                return args, kwargs
            stack.callback(model.roi_head.register_forward_pre_hook(
                pin, with_kwargs=True).remove)
        preds = model(*inputs)
        model.get_bboxes(preds)
    out = dict(zoo_preds(preds), head_input=head_in.x)
    if unet:
        out['unet_features'] = unet['x']
    for i, (fn, args, kwargs, _) in enumerate(nms.calls):
        boxes = args[0]                 # centres, or the decoded boxes
        scores = args[1] if fn.__name__ == 'circle_nms' else args[2]
        out[f'nms{i}.boxes'] = boxes
        out[f'nms{i}.scores'] = scores
    return out, top.index, kept


# outputs a twin holds to TOL: the sparse convs' (the head's input, Part-A2's
# full-resolution U-Net features)
AT_TOL = ('head_input', 'unet_features')


def zoo_twin(label, model, inputs, at_tol=AT_TOL):
    """The kernel path against the all-plain one (x3 product, rounding
    pinned, the kernel path's top K and, for Part-A2, its RoIs):
    ``at_tol`` (the head input, the U-Net's features) within TOL of its
    largest value, the head's outputs, the decoded candidates and the RoI
    stage's outputs within FLOOR_MARGIN times the plain path's own spread
    under reordered sums (never below TOL); the yaw of the anchor heads'
    boxes (an angle from a residual and a direction bin) printed, not
    held; integer and mask outputs equal. The packed engine's twin holds
    everything to the spread (phase 6's limit: ``at_tol=()``)."""
    import torch
    from msmdfusion_torch import kernels
    pins = PinnedRounding()
    run, index, rois = zoo_outputs(model, inputs, None, pins)
    ref, _, _ = zoo_outputs(model, inputs, index, kernels.plain_kernels(),
                            X3Plain(), pins.replay(), rois=rois)
    alt, _, _ = zoo_outputs(model, inputs, index, kernels.plain_kernels(),
                            X3Plain(), ReorderedSums(), pins.replay(),
                            rois=rois)
    check(run.keys() == ref.keys(), f'{label}: the twin decoded '
          f'{sorted(ref)}, the kernel path {sorted(run)}')
    worst = {}
    for key in run:
        got, want, other = run[key], ref[key], alt[key]
        if not got.is_floating_point():
            check(torch.equal(got, want), f'{label}: {key} differs between '
                  'the kernel and plain paths')
            continue
        if key.startswith('nms') and key.endswith('.boxes') and \
                got.shape[-1] > YAW:
            worst[key + '.yaw'] = (rel_err(got[..., YAW], want[..., YAW])[1],
                                   float('nan'))
            got, want, other = (boxes_part(dict(bboxes=x), 'bboxes')
                                for x in (got, want, other))
        rel = rel_err(got, want)[1]
        floor = rel_err(other, want)[1]
        limit = TOL if key in at_tol else max(TOL, FLOOR_MARGIN * floor)
        worst[key] = (rel, limit)
        check(rel <= limit, f'{label}: {key}: kernel vs plain path {rel:.3g} '
              f'of max |ref|, above {limit:.3g} (reordered plain path '
              f'{floor:.3g})')
    top = sorted(((k, v) for k, v in worst.items() if k != 'head_input'),
                 key=lambda kv: -(kv[1][0] / kv[1][1])
                 if kv[1][1] == kv[1][1] else 0)
    print(f'{label}: kernel vs plain path (pinned rounding, the kernel '
          f'path\'s top K): head_input {worst["head_input"][0]:.3g} of max '
          f'(limit {worst["head_input"][1]:.3g}); ' + '; '.join(
              f'{k} {r:.3g}' + (f' (limit {lim:.3g})' if lim == lim else
                                ' (not held)')
              for k, (r, lim) in top[:12]), flush=True)
    return worst


def zoo_same_bits(label, model, inputs):
    """Two forwards and decodes: every output the same bits."""
    import torch
    outs = []
    for _ in range(2):
        with torch.no_grad():
            preds = model(*inputs)
            boxes = model.get_bboxes(preds)
        outs.append(dict(zoo_preds(preds), **{f'det.{k}': v
                                              for k, v in boxes.items()}))
    differ = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
    check(not differ, f'{label}: two forwards differ in {differ}')
    print(f'{label}: two forwards and decodes bit-equal ({len(outs[0])} '
          'outputs)', flush=True)


def zoo_frame(label, model, inputs, spec, card, twin=False):
    """One counted inference frame (launches, overflow per site, the NMS
    against the CPU, the boxes), the twin where ``twin``, two forwards
    bit-equal, ``ZOO['frames']`` frames timed by CUDA events after a
    warm-up, stage ms. Returns (ms/frame, overflow, launches)."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.utils import overflow, timing
    model.eval()
    with torch.no_grad():
        kernels.reset_launches()
        with overflow.capture() as cap, NmsCalls() as nms:
            preds = model(*inputs)
            boxes = model.get_bboxes(preds)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
    print(f'{label}: launches on the main path: {launches}', flush=True)
    check_launches(label, launches, spec['launches'])
    dropped = {k: v for k, v in cap.counters().items() if v}
    occupancy = {k: v for k, v in cap.gauge_values().items()
                 if k.startswith('occ.')}
    print(f'{label}: overflow per site {dropped} (every other site 0); '
          f'occupancy {occupancy}', flush=True)
    key = 'bboxes' if 'bboxes' in boxes else 'boxes'
    b, valid = boxes[key], boxes['valid']
    check(bool(torch.isfinite(b).all()) and int(valid.sum()) > 0,
          f'{label}: {int(valid.sum())} valid boxes, finite '
          f'{bool(torch.isfinite(b).all())}')
    print(f'{label}: {int(valid.sum())} of {valid.numel()} boxes kept, '
          f'{tuple(b.shape)}', flush=True)
    nms_check(label, nms.calls)
    if twin:
        zoo_twin(label, model, inputs)
    zoo_same_bits(label, model, inputs)
    with torch.no_grad():
        frame_ms = cuda_ms(lambda: forward(model, inputs), ZOO['frames'])
        with timing.record(inputs[0].device.type) as tr:
            forward(model, inputs)
    stage_ms = {k: round(v, 4) for k, v in tr.ms().items()}
    print(f'{label}: e2e {frame_ms:.3f} ms/frame (CUDA events, '
          f'{ZOO["frames"]} frames after a warm-up), {1e3 / frame_ms:.2f} '
          f'frames/s; stage_ms of a frame after them {json.dumps(stage_ms)} '
          f'[{card}]', flush=True)
    return frame_ms, dropped, launches


def zoo_step(label, model, inputs, gt, config, spec, card, restart=False):
    """One counted ``make_train_step`` step of the config's recipe
    (launches, overflow per site, finite losses), then ``ZOO['steps']``
    steps timed at their seams (``split_steps``; with ``restart`` each
    from the weights the counted step started from). The weights are
    restored after. Returns (ms/step, overflow, launches)."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.train import (build_lr_schedule,
                                             build_optimizer,
                                             make_train_step)
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.utils import overflow
    cfg = load_config(str(config))
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    try:
        schedule = build_lr_schedule(
            dict(cfg.lr_config), cfg.optimizer['lr'],
            cfg.total_epochs * ZOO['steps_per_epoch'],
            ZOO['steps_per_epoch'])
        opt = build_optimizer(model, dict(cfg.optimizer),
                              dict(cfg.optimizer_config), schedule)
        step = make_train_step(model, opt, seed=SEED)
        batch = dict(inputs=inputs, gt_bboxes=gt[0], gt_labels=gt[1],
                     gt_valid=gt[2])
        kernels.reset_launches()
        with overflow.capture() as cap:
            metrics = step(batch, 0)
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
        losses = {k: round(float(v), 5) for k, v in metrics.items()}
        check(all(math.isfinite(v) for v in losses.values()),
              f'{label}: losses {losses}')
        print(f'{label}: launches of one step {launches}; losses {losses}',
              flush=True)
        check_launches(label, launches, spec['train'])
        dropped = {k: v for k, v in cap.counters().items() if v}
        voxels = getattr(model, 'pts_voxel_layer', None)
        print(f'{label}: batch {inputs[0].shape[0]}, overflow per site '
              f'{dropped} (every other site 0' + (
                  f'; the train-time voxel capacity '
                  f'{voxels["max_voxels"][0]}' if voxels else '') + ')',
              flush=True)
        split = split_steps(label, step, model, opt, batch, ZOO['steps'],
                            card, restore=start if restart else None)
        step_ms = sum(sum(s) for s in split) / len(split)
        return step_ms, dropped, launches
    finally:
        model.load_state_dict(start)
        model.eval()
        torch.cuda.empty_cache()


def zoo(card, dev):
    """Phase 22 (see ``ZOO``): (a)-(e). Returns {path: figures}."""
    import torch
    from msmdfusion_torch.ops.voxelize import voxelize_batch
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    out = {}

    def setup(name, inputs):
        t0 = time.perf_counter()
        model = zoo_model(ZOO[name]['config'], dev)
        with torch.no_grad():
            calibrate_norms(model, *inputs)
        print(f'zoo {name}: {ZOO[name]["config"].name} built, norms '
              f'calibrated in {time.perf_counter() - t0:.1f} s', flush=True)
        return model

    # (a) CenterPoint on phase 3's frame
    cp = zoo_model(ZOO['centerpoint']['config'], dev)
    inputs, gt = make_points(cp, ZOO['n_points'], dev)
    del cp
    label = 'zoo (a) CenterPoint'
    model = setup('centerpoint', inputs)
    frame = zoo_frame(label, model, inputs, ZOO['centerpoint'], card,
                      twin=True)
    step = zoo_step(f'{label} train', model, inputs, gt,
                    ZOO['centerpoint']['config'], ZOO['centerpoint'], card)
    out['centerpoint'] = (frame, step)
    del model
    torch.cuda.empty_cache()

    # (b) PointPillars and (e) FreeAnchor on the same frame
    label = 'zoo (b) PointPillars'
    model = setup('pointpillars', inputs)
    frame = zoo_frame(label, model, inputs, ZOO['pointpillars'], card)
    vl = model.pts_voxel_layer
    cap = vl['max_voxels']
    with torch.no_grad():
        pillars = int(voxelize_batch(*inputs, vl['voxel_size'],
                                     vl['point_cloud_range'],
                                     vl['max_num_points'], cap[1])[3].sum())
    print(f'{label}: {pillars} pillars against the cap {cap[1]} (train '
          f'{cap[0]}): dropped {frame[1].get("voxelize.hard.voxel_cap", 0)} '
          f'pillars, {frame[1].get("voxelize.hard.point_truncation", 0)} '
          f'points past {vl["max_num_points"]} a pillar', flush=True)
    step = zoo_step(f'{label} train', model, inputs, gt,
                    ZOO['pointpillars']['config'], ZOO['pointpillars'], card)
    out['pointpillars'] = (frame, step)
    del model
    label = 'zoo (e) FreeAnchor'
    model = setup('free_anchor', inputs)
    out['free_anchor'] = (None, zoo_step(
        f'{label} train', model, inputs, gt, ZOO['free_anchor']['config'],
        ZOO['free_anchor'], card))
    del model, inputs, gt
    torch.cuda.empty_cache()

    # (c) SECOND and (d) DynamicVoxelNet on a KITTI-range frame
    second = zoo_model(ZOO['second']['config'], dev)
    inputs, gt = kitti_frame(second, ZOO['kitti_points'], dev)
    del second
    label = 'zoo (c) SECOND'
    model = setup('second', inputs)
    frame = zoo_frame(label, model, inputs, ZOO['second'], card, twin=True)
    step = zoo_step(f'{label} train', model, inputs, gt,
                    ZOO['second']['config'], ZOO['second'], card)
    out['second'] = (frame, step)
    del model
    label = 'zoo (d) DynamicVoxelNet'
    model = setup('dynamic', inputs)
    out['dynamic'] = (zoo_frame(label, model, inputs, ZOO['dynamic'], card),
                      None)
    del model, inputs, gt
    torch.cuda.empty_cache()
    summary = {k: dict(ms_frame=f and round(f[0], 3),
                       ms_step=s and round(s[0], 3),
                       overflow={**(f[1] if f else {}),
                                 **{f'train {k2}': v for k2, v in
                                    (s[1] if s else {}).items()}})
               for k, (f, s) in out.items()}
    print(f'zoo: {json.dumps(summary)} [{card}]', flush=True)
    return out


# phase 22 from files: CenterPoint on phase 17's samples (the eval CLI,
# then ``steps`` train-CLI steps), SECOND on a KITTI-format set of (c)'s
# frame (``write_waymo``'s layout, 4-float velodyne files) through both
# CLIs: ``steps`` steps of six samples, then ``val`` frames evaluated
ZOO_FILES = dict(steps=2, val=2)


def zoo_checkpoint(config, opts, dev, name):
    """A checkpoint of ``config``'s seed-0 weights with norms calibrated
    on its test set's first sample, and that sample's inputs."""
    import torch
    from msmdfusion_torch.apis.inference import batch_model_inputs
    from msmdfusion_torch.config import load_config, parse_cli_overrides
    from msmdfusion_torch.datasets.loader import DataLoader
    from msmdfusion_torch.models.builder import build_detector
    from msmdfusion_torch.registry import DATASETS
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    from msmdfusion_torch.utils.checkpoint import save_checkpoint
    cfg = load_config(config, parse_cli_overrides(opts))
    dataset = DATASETS.build(dict(cfg.data.test))
    model = build_detector(cfg.model, device=dev, seed=SEED)
    with DataLoader(dataset, 1, shuffle=False, drop_last=False,
                    num_workers=0, device=dev) as loader:
        inputs = batch_model_inputs(cfg.model.type, next(iter(loader)), dev)
    with torch.no_grad():
        calibrate_norms(model, *inputs)
    return save_checkpoint(str(Path(name).resolve()), 0, model,
                           meta=dict(config=config)), inputs


def zoo_eval_cli(label, config, ckpt, opts, metric, inputs, launches, card,
                 dev, width, keys=None):
    """The eval CLI with ``--eval``: every frame's launches, the overflow
    per site, finite metrics (``keys`` printed, else the first four),
    sample 0's detections bit-equal to a direct call; returns the CLI's
    frames/s."""
    import numpy as np
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.apis.inference import unpack_detections
    from msmdfusion_torch.tools import test as test_cli
    kernels.reset_launches()
    run = test_cli.main([config, ckpt, '--eval', metric, '--device',
                         str(dev)] + (['--cfg-options', *opts] if opts
                                      else []))
    torch.cuda.synchronize()
    n = len(run['results'])
    check_launches(f'{label}: eval CLI', dict(kernels.launches),
                   {k: v * n for k, v in launches.items()})
    numbers = {k: v for k, v in run['metrics'].items()
               if isinstance(v, (int, float))}
    check(numbers and all(math.isfinite(v) for v in numbers.values()),
          f'{label}: metrics {run["metrics"]}')
    model = run['model']
    with torch.no_grad():
        direct = unpack_detections(model.get_bboxes(model(*inputs)))[0]
    for key in ('bboxes', 'scores', 'labels'):
        check(np.array_equal(run['results'][0][key], direct[key]),
              f'{label}: sample 0 {key} differ from the direct call')
    check(all(np.isfinite(d['bboxes']).all() and d['bboxes'].shape[1]
              == width for d in run['results']), f'{label}: boxes')
    shown = ({k: numbers[k] for k in keys} if keys
             else dict(list(numbers.items())[:4]))
    dropped = {k: v for k, v in run['overflow'].items() if v}
    print(f'{label}: eval CLI --eval {metric}: {n} frames, '
          f'{run["fps"]:.3f} frames/s whole run ({run["seconds"]:.2f} s, '
          f'worker start-up in it); launches {launches} a frame; overflow '
          f'per site {dropped} (every other site 0); sample 0\'s '
          f'{len(direct["scores"])} '
          f'detections bit-equal to the direct call; {shown} (seed weights:'
          f' no meaning) [{card}]', flush=True)
    fps = run['fps']
    del run, model
    torch.cuda.empty_cache()
    return fps


def zoo_train_cli(label, config, work, opts, steps, launches, card, dev):
    """``steps`` steps of the train CLI: the launches, finite losses, the
    overflow per site; returns its seconds."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.tools import train as train_cli
    from msmdfusion_torch.utils import overflow
    kernels.reset_launches()
    t0 = time.perf_counter()
    with overflow.capture() as cap:
        run = train_cli.main([config, '--work-dir', work, '--device',
                              str(dev), '--max-steps', str(steps),
                              '--no-validate', '--cfg-options', *opts,
                              'log_config.interval=1'])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_launches(f'{label}: train CLI', dict(kernels.launches),
                   {k: v * steps for k, v in launches.items()})
    train = [r for r in json_records(work) if r['mode'] == 'train']
    check(len(train) == steps and all(math.isfinite(r['total_loss'])
                                      for r in train),
          f'{label}: train records {train}')
    print(f'{label}: train CLI {steps} steps in {seconds:.1f} s; total_loss '
          f'{[round(r["total_loss"], 4) for r in train]}; launches '
          f'{launches} a step; overflow per site '
          f'{ {k: v for k, v in cap.counters().items() if v} } [{card}]',
          flush=True)
    del run
    torch.cuda.empty_cache()
    return seconds


def zoo_files(card, dev, files):
    """Phase 22 (f), inside phase 17's working directory: CenterPoint
    through the eval CLI over phase 17's nuScenes-layout samples (``--eval
    bbox``, then its timed pass), then ``ZOO_FILES['steps']`` train-CLI
    steps."""
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.tools import test as test_cli
    label = 'zoo (f) CenterPoint from files'
    config = str(ZOO['centerpoint']['config'])
    test_opts = data_options('test', files['root'], files['ann'])
    ckpt, inputs = zoo_checkpoint(config, test_opts, dev, 'ckpt_centerpoint')
    zoo_eval_cli(label, config, ckpt, test_opts, 'bbox', inputs,
                 ZOO['centerpoint']['launches'], card, dev, 9)
    # the timed pass: phase 17's timed info file (its samples listed
    # ENTRY['timed'] times); steady frames/s from frame 2 x workers on
    cfg = load_config(config)
    skip = 2 * cfg.data.workers_per_gpu
    run = test_cli.main([config, ckpt, '--device', str(dev), '--cfg-options',
                         *data_options('test', files['root'],
                                       files['timed_ann'])])
    n = len(run['results'])
    check(n == ENTRY['timed'], f'{label}: timed pass {n} results')
    cli_ms = steady_ms(run['frame_s'], skip)
    print(f'{label}: timed pass, {n} frames: eval CLI {1e3 / cli_ms:.3f} '
          f'frames/s ({cli_ms:.1f} ms/frame from frame {skip} on, host '
          f'clock); overflow per site '
          f'{ {k: v for k, v in run["overflow"].items() if v} } [{card}]',
          flush=True)
    del run
    zoo_train_cli(label, config, str(Path('work_centerpoint').resolve()),
                  data_options('train.dataset', files['root'], files['ann']),
                  ZOO_FILES['steps'], ZOO['centerpoint']['train'], card, dev)
    return 1e3 / cli_ms


def second_files(card, dev, spec=ZOO_FILES):
    """Phase 22 (g): SECOND through the train and eval CLIs on a
    KITTI-format set of (c)'s frame."""
    import tempfile
    import numpy as np
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.utils.synth_scene import lidar_scene, scene_gt
    label = 'zoo (g) SECOND from files'
    config = str(ZOO['second']['config'])
    cfg = load_config(config)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        pts, objects = lidar_scene(np.random.RandomState(SEED),
                                   ZOO['kitti_points'], cfg.point_cloud_range)
        boxes, labels, valid = scene_gt(objects)
        frame = (pts, boxes[valid][:, :7],
                 labels[valid] % len(cfg.class_names))
        n_train = spec['steps'] * cfg.data.samples_per_gpu
        paths = write_waymo(cfg.data_root, [frame],
                            dict(train=n_train, val=spec['val']),
                            cfg.class_names, prefix='kitti', columns=4)
        check(paths['train'] == Path(cfg.data.train.ann_file)
              and paths['val'] == Path(cfg.data.test.ann_file),
              f'{label}: wrote {paths}, the config reads '
              f'{cfg.data.train.ann_file} and {cfg.data.test.ann_file}')
        print(f'{label}: (c)\'s {len(pts)}-point frame and its '
              f'{len(frame[1])} boxes as a KITTI-format set under '
              f'{cfg.data_root} ({n_train} train, {spec["val"]} val infos)',
              flush=True)
        zoo_train_cli(label, config, str(Path('work_second').resolve()), [],
                      spec['steps'], ZOO['second']['train'], card, dev)
        ckpt, inputs = zoo_checkpoint(config, [], dev, 'ckpt_second')
        return zoo_eval_cli(label, config, ckpt, [], 'kitti', inputs,
                            ZOO['second']['launches'], card, dev, 7)


# phase 23: the two-stage and fusion zoo at their configs' widths and
# capacities on (c)'s 40,000-point KITTI frame: Part-A2 (the U-Net's
# decoder adds 4 fresh submanifold plans and convs to SECOND's 8 and 12,
# inputs 128/96/48/32 wide: 12/16 a frame; a step adds the 4 strided
# convs' duals, d_feats for every conv but conv_input and dw for all 16)
# and MVXNet with one 384 x 1248 view (SECOND's 8/12, conv_input 128
# wide: PointFusion's mid_channels; in a step its input takes a
# gradient: d_feats for all 12); then test-time augmentation over phase
# 3's TransFusion-L, 4 views (horizontal x vertical flip, scale 1)
TWO_STAGE = dict(
    parta2=dict(config=ROOT / 'configs' / 'parta2_kitti.py',
                launches={'rows_affine': 12, 'gather_gemm_conv_x3': 16},
                train={'rows_affine': 12, 'rows_queries': 4,
                       'gather_gemm_conv_x3': 31, 'conv_dw_x3': 16},
                packed={'rows_affine': 12, 'gather_gemm_conv_bf16': 16},
                onehot={'match_conv_x3': 16},
                widths={(128, 64), (96, 32), (48, 16), (32, 16)}),
    mvxnet=dict(config=ROOT / 'configs' / 'mvxnet_kitti.py',
                launches={'rows_affine': 8, 'gather_gemm_conv_x3': 12},
                train={'rows_affine': 8, 'rows_queries': 4,
                       'gather_gemm_conv_x3': 24, 'conv_dw_x3': 12},
                widths={(128, 16)}),
    img_hw=(384, 1248), tta_views=4, tta_rounds=3)
# KITTI's published camera-2 projection (the object benchmark's
# training/calib/000000.txt P2), and the velodyne-to-camera axis swap
# (camera x = -y, y = -z, z = x of the LiDAR)
KITTI_P2 = ((721.5377, 0.0, 609.5593, 44.85728),
            (0.0, 721.5377, 172.854, 0.2163791),
            (0.0, 0.0, 1.0, 0.002745884))
VELO_TO_CAM = ((0.0, -1.0, 0.0, 0.0), (0.0, 0.0, -1.0, 0.0),
               (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def kitti_view(img_hw, dev):
    """One seeded view [1, 1, H, W, 3] (normalised pixel scale) and its
    metas, lidar2img [1, 1, 4, 4]: P2 after the axis swap."""
    import torch
    p2 = torch.eye(4, dtype=torch.float64)
    p2[:3] = torch.tensor(KITTI_P2, dtype=torch.float64)
    l2i = (p2 @ torch.tensor(VELO_TO_CAM, dtype=torch.float64)).float()
    gen = torch.Generator().manual_seed(SEED)
    img = torch.randn(1, 1, *img_hw, 3, generator=gen)
    return img.to(dev), dict(lidar2img=l2i[None, None].to(dev))


def centre_share(model, inputs):
    """The share of the frame's voxel centres (test-time voxels) that
    project onto the view."""
    import torch
    from msmdfusion_torch.models.fusion_layers import project_points_to_image
    from msmdfusion_torch.ops.voxelize import voxelize_batch
    vl = model.pts_voxel_layer
    points, mask, img, metas = inputs
    with torch.no_grad():
        _, _, coors, valid = voxelize_batch(
            points, mask, vl['voxel_size'], vl['point_cloud_range'],
            vl['max_num_points'], model.max_voxels())
        size = points.new_tensor(vl['voxel_size'])
        origin = points.new_tensor(vl['point_cloud_range'][:3])
        centers = (coors[:, 1:].flip(-1).float() + 0.5) * size + origin
        _, ok = project_points_to_image(centers, metas['lidar2img'][0, 0],
                                        tuple(img.shape[2:4]))
    return int((ok & valid).sum()), int(valid.sum())


def new_width_calls(label, model, inputs, widths, plans, card):
    """The conv calls of one forward whose (Cin, Cout) is in ``widths``
    (the path's new widths) and the rows calls of their plans (the slice
    ``plans`` of the forward's rows calls), each against its plain version
    (``conv_calls``, ``rows_calls``), timed."""
    import torch
    with torch.no_grad(), Recorder() as rec:
        forward(model, inputs)
    torch.cuda.synchronize()
    convs = [c for c in rec.calls['gather_gemm_conv']
             if tuple(c[0][2].shape[1:]) in widths]
    recs = {'gather_gemm_conv_x3': conv_calls(
        convs, widths, 4, card, plain_reps=1, label=f'{label} new widths'),
        'rows_affine': rows_calls('rows_affine', rec.calls['rows_affine'][
            plans], 4, card)}
    del rec
    sums_lines(f'{label}: %s over the new widths\' calls', recs, card)
    return recs


def roi_engines(model, card, rois=100, reps=3):
    """The RoI head's largest dense 3-D conv (``merge_conv_0`` over
    ``rois`` RoIs' grids) forward and forward + backward, on and off
    cuDNN (``engine_lines``)."""
    import torch
    head = model.roi_head
    conv = head.merge_conv_0
    g = head.roi_grid
    x = torch.randn(rois, conv.in_channels, *g, device=conv.weight.device,
                    requires_grad=True)

    def both():
        conv(x).sum().backward()
    with torch.no_grad():
        engine_lines([(f'RoI head merge_conv_0 {rois}x{conv.in_channels}x'
                       f'{"x".join(map(str, g))} -> {conv.out_channels}',
                       lambda: conv(x))], card, reps)
    engine_lines([('the same, forward + backward', both)], card, reps)
    model.zero_grad(set_to_none=True)


def engine_frames(label, model, inputs, spec, card):
    """Part-A2 under the packed bf16 and the one-hot engines: one frame
    each, launches counted, the twin at the RPN input (the packed one
    held to FLOOR_MARGIN x the plain path's spread throughout, phase 6's
    limit; the one-hot one to TOL up to the head, phase 7's). Returns
    {engine: launches}."""
    import torch
    from msmdfusion_torch import kernels
    out = {}
    for name, env, expected, at_tol in (
            ('packed bf16', PACKED['env'], spec['packed'], ()),
            ('one-hot', ONEHOT['env'], spec['onehot'], AT_TOL)):
        with switches(env), torch.no_grad():
            kernels.reset_launches()
            forward(model, inputs)
            launches = dict(kernels.launches)
            torch.cuda.synchronize()
            print(f'{label} {name}: launches of a frame {launches}',
                  flush=True)
            check_launches(f'{label} {name}', launches, expected)
            zoo_twin(f'{label} {name}', model, inputs, at_tol=at_tol)
        out[name] = launches
    return out


def tta(card, dev, tl_kept):
    """(e): ``aug_test_detector`` over phase 3's TransFusion-L and frame, 4
    views from ``MultiScaleFlipAug3D``: launches (4 frames'), boxes before
    and after the merge, two runs bit-equal, ms per merged frame."""
    import numpy as np
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.datasets.pipelines.test_time_aug import \
        MultiScaleFlipAug3D
    from msmdfusion_torch.models.detectors.mvx_two_stage import \
        aug_test_detector
    label = 'two-stage (e) TTA TransFusion-L'
    model = build_model(dev, max_voxels=TL['max_voxels'])
    model.load_state_dict(tl_kept['state'])
    model.eval()
    points, mask = tl_kept['inputs']
    views = MultiScaleFlipAug3D(
        [], flip=True, pcd_horizontal_flip=True, pcd_vertical_flip=True)(
        dict(points=points[0].cpu().numpy()))['aug_samples']
    check(len(views) == TWO_STAGE['tta_views'], f'{label}: {len(views)} '
          'views')
    aug = [dict(points=torch.from_numpy(v['points'])[None].to(dev),
                points_mask=mask, aug=v['aug_state']) for v in views]
    with torch.no_grad():
        before = sum(int(model.simple_test(v['points'], mask)['valid'].sum())
                     for v in aug)
    kernels.reset_launches()
    merged = aug_test_detector(model, aug)
    launches = dict(kernels.launches)
    check_launches(label, launches, {k: v * len(aug) for k, v in
                                     TL['launches'].items()})
    again = aug_test_detector(model, aug)
    check(all(np.array_equal(merged[k], again[k]) for k in merged),
          f'{label}: two runs differ')
    n = len(merged['scores'])
    check(0 < n <= before and np.isfinite(merged['bboxes']).all(),
          f'{label}: {n} merged boxes of {before}')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TWO_STAGE['tta_rounds']):
        aug_test_detector(model, aug)
    ms = (time.perf_counter() - t0) / TWO_STAGE['tta_rounds'] * 1e3
    print(f'{label}: {len(aug)} views {[v["aug_state"] for v in views]}; '
          f'launches {launches}; {before} boxes before the merge, {n} after '
          f'(circle NMS, 0.3 m); two runs bit-equal; {ms:.3f} ms per merged '
          f'frame (host clock, {TWO_STAGE["tta_rounds"]} rounds, the '
          f'merge on the host) [{card}]', flush=True)
    return ms, launches


def two_stage(card, dev, tl_kept):
    """Phase 23 (see ``TWO_STAGE``): (a)-(e). Returns {path: launches}
    for the kernels line."""
    import torch
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    paths = {}

    def setup(name, frame):
        t0 = time.perf_counter()
        model = zoo_model(TWO_STAGE[name]['config'], dev)
        inputs, gt = frame(model)
        with torch.no_grad():
            calibrate_norms(model, *inputs)
        print(f'two-stage {name}: {TWO_STAGE[name]["config"].name} built, '
              f'{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M '
              f'parameters, norms calibrated in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        return model, inputs, gt

    # (a), (b) Part-A2
    spec = TWO_STAGE['parta2']
    label = 'two-stage (a) Part-A2'
    model, inputs, gt = setup('parta2', lambda m: kitti_frame(
        m, ZOO['kitti_points'], dev))
    with torch.no_grad():
        shapes = {k: tuple(v.shape) for k, v in zoo_preds(
            model(*inputs)).items() if k.startswith(('rpn.', 'roi.rois'))}
    check(shapes['roi.rois'] == (1, 100, 7) and shapes['rpn.cls_score']
          == (1, 18, 200, 176), f'{label}: output shapes {shapes}')
    print(f'{label}: outputs {shapes}', flush=True)
    # the U-Net decoder's four convs and their plans, the forward's last
    new_width_calls(label, model, inputs, spec['widths'], slice(-4, None),
                    card)
    frame = zoo_frame(label, model, inputs, spec, card, twin=True)
    roi_engines(model, card)
    engines = engine_frames(label, model, inputs, spec, card)
    # each timed step from the calibrated weights: on the seed's weights,
    # after one update of the config's recipe the next step's RoIs span
    # sizes of 1e-15 to 1e12 m and the corner loss's square overflows
    # fp32, a NaN gradient on the kernels and on the plain versions alike
    step = zoo_step('two-stage (b) Part-A2 train', model, inputs, gt,
                    spec['config'], spec, card, restart=True)
    paths['parta2'] = (frame[2], step[2])
    paths.update({f'parta2 {k}': (v, {}) for k, v in engines.items()})
    lidar = inputs
    del model, inputs
    torch.cuda.empty_cache()

    # (c), (d) MVXNet with one view
    spec = TWO_STAGE['mvxnet']
    label = 'two-stage (c) MVXNet'
    model, inputs, gt = setup('mvxnet', lambda m: (
        lidar + kitti_view(TWO_STAGE['img_hw'], dev), gt))
    conv = model.pts_middle_encoder.conv_input[0].taps()
    check(tuple(conv.shape) == (27, 128, 16), f'{label}: the first sparse '
          f'conv\'s taps {tuple(conv.shape)}')
    on, total = centre_share(model, inputs)
    print(f'{label}: first sparse conv taps {tuple(conv.shape)}; {on} of '
          f'{total} voxel centres ({on / max(total, 1):.3f}) on the '
          f'{TWO_STAGE["img_hw"]} view (KITTI P2, the axis swap)',
          flush=True)
    # conv_input (PointFusion's 128 channels) and its plan, the first
    new_width_calls(label, model, inputs, spec['widths'], slice(0, 1), card)
    frame = zoo_frame(label, model, inputs, spec, card, twin=True)
    step = zoo_step('two-stage (d) MVXNet train', model, inputs, gt,
                    spec['config'], spec, card)
    paths['mvxnet'] = (frame[2], step[2])
    del model, inputs, gt, lidar
    torch.cuda.empty_cache()

    # (e) test-time augmentation
    paths['tta'] = (tta(card, dev, tl_kept)[1], {})
    summary = {k: dict(frame=f, step=s) for k, (f, s) in paths.items()}
    print(f'two-stage: launches {json.dumps(summary)} [{card}]', flush=True)
    return {f'{k} {part}': launches for k, (f, s) in paths.items()
            for part, launches in (('frame', f), ('step', s)) if launches}


# phase 24: the point-based zoo at its configs' widths: (a) VoteNet on a
# ScanNet-like room (``synth_scene.indoor_room``: a floor, walls and 12
# pieces of furniture of the config's 18 classes, 50,000 points) through
# the config's test pipeline (40,000 points with the height channel),
# (b) H3DNet on the same room, (c) SSD3DNet on phase 22's KITTI frame
# sampled to 16,384 points, (d) ImVoteNet on a SUN RGB-D-like room
# (turned boxes, 20,000 points) in front of a seeded pinhole, one seeded
# 530 x 730 image and 8 2-D boxes (6 from the objects, 2 padded invalid),
# both image paths; (e) VoteNet through the train and eval CLIs on a
# ScanNet-layout set of (a)'s room and a second one, and a SUN RGB-D-layout
# info file read through SUNRGBDDataset. None of the six kernels runs on
# these paths: the point ops and the FPS loop are PyTorch's.
POINT_ZOO = dict(
    votenet=dict(config=ROOT / 'configs' / 'votenet_scannet.py'),
    h3dnet=dict(config=ROOT / 'configs' / 'h3dnet_scannet.py'),
    ssd3d=dict(config=ROOT / 'configs' / 'ssd3d_kitti.py'),
    imvotenet=dict(config=ROOT / 'configs' / 'imvotenet_sunrgbd.py'),
    room_points=50000, img_hw=(530, 730), focal=250.0, boxes_2d=8,
    frames=10, other_frames=3, files_steps=2, files_val=2)


def room_frame(config, seed, yawed=False, shift=(0.0, 0.0, 0.0)):
    """A seeded room (``indoor_room``) of the config's classes and mean
    sizes, moved by ``shift``, through the config's test pipeline: points
    [N, 4] (xyz and the height over the 0.99th percentile of z), the
    room itself and its boxes bottom-centre [K, 7]."""
    import tempfile
    import numpy as np
    import msmdfusion_torch.datasets  # noqa: F401
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.datasets.pipelines import Compose
    from msmdfusion_torch.utils.synth_scene import indoor_room
    cfg = load_config(str(config))
    mapping = [t for t in cfg.train_pipeline
               if t['type'] == 'PointSegClassMapping']
    cat_ids = (mapping[0]['valid_cat_ids'] if mapping
               else tuple(range(len(cfg.class_names))))
    room = indoor_room(np.random.RandomState(seed), POINT_ZOO['room_points'],
                       cfg.model.bbox_head['mean_sizes'], cat_ids,
                       yawed=yawed)
    room['points'][:, :3] += np.asarray(shift, np.float32)
    room['boxes'][:, :3] += np.asarray(shift, np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / 'room.bin')
        room['points'].tofile(path)
        out = Compose(cfg.test_pipeline)(
            dict(pts_filename=path, sweeps=[], timestamp=0),
            np.random.RandomState(seed))
    boxes = room['boxes'].copy()
    boxes[:, 2] -= boxes[:, 5] / 2
    return out['points'], room, boxes


def batch_of(frames, dev):
    """[(points [N, F], boxes [K, 7], labels [K])] -> ((points, mask),
    (boxes, labels int32, valid)) on ``dev``."""
    import numpy as np
    import torch
    k = max(len(f[1]) for f in frames)
    boxes = np.zeros((len(frames), k, 7), np.float32)
    labels = np.zeros((len(frames), k), np.int32)
    valid = np.zeros((len(frames), k), bool)
    for i, (_, b, lab) in enumerate(frames):
        boxes[i, :len(b)], labels[i, :len(b)], valid[i, :len(b)] = b, lab, 1
    pts = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    return (pts, mask), tuple(torch.from_numpy(x).to(dev)
                              for x in (boxes, labels, valid))


def pinhole(rt_pitch=0.15):
    """SUN RGB-D-style calibration: K [4, 4] (focal ``POINT_ZOO['focal']``,
    the principal point at the image centre) and Rt [3, 3] (a pitch of
    ``rt_pitch`` rad about x), and the lidar2img [4, 4] that takes DEPTH
    points to pixels through them (``box_modes``' DEPTH -> CAM with Rt)."""
    import numpy as np
    from msmdfusion_torch.core import box_modes
    h, w = POINT_ZOO['img_hw']
    f = POINT_ZOO['focal']
    k = np.eye(4, dtype=np.float32)
    k[:3, :3] = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    c, s = np.cos(rt_pitch), np.sin(rt_pitch)
    rt = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    to_cam = np.eye(4, dtype=np.float32)
    to_cam[:3, :3] = box_modes._DEFAULT_RT[(box_modes.DEPTH, box_modes.CAM)] \
        @ rt.T
    return k, rt, k @ to_cam


def boxes_2d(boxes, labels, l2i, n, rng):
    """Up to ``n`` 2-D detections [n, 6] (l, t, r, b, conf, cls): the
    projected corners' extent of the first objects in front of the
    camera, seeded confidences, the last two rows padded and invalid."""
    import numpy as np
    import torch
    from msmdfusion_torch.core.boxes import corners_3d
    h, w = POINT_ZOO['img_hw']
    out = np.zeros((n, 6), np.float32)
    valid = np.zeros(n, bool)
    corners = corners_3d(torch.from_numpy(boxes)).numpy()        # [K, 8, 3]
    hom = np.concatenate([corners, np.ones(corners.shape[:2] + (1,))], -1)
    proj = hom @ l2i.T
    k = 0
    for j in range(len(boxes)):
        if k == n - 2:
            break
        if (proj[j, :, 2] <= 0.1).any():
            continue
        uv = proj[j, :, :2] / proj[j, :, 2:3]
        lo = np.clip(uv.min(0), 0, [w - 1, h - 1])
        hi = np.clip(uv.max(0), 0, [w - 1, h - 1])
        if (hi - lo).min() < 4:
            continue
        out[k] = [*lo, *hi, rng.uniform(0.4, 0.95), labels[j]]
        valid[k] = True
        k += 1
    return out, valid


def imvote_frame(config, seeds, dev):
    """(d)'s batch: rooms in front of ``pinhole()`` (the camera at the
    origin looking along y, 1.2 m above the floor), one seeded image each,
    their 2-D boxes; returns (points, mask, img [B, H, W, 3] 0-255, metas
    with bboxes_2d, bbox_valid, depth2img dict(K, Rt)), the image path's
    (img [B, 1, H, W, 3] normalised, metas lidar2img [B, 1, 4, 4]) and
    the ground truth."""
    import numpy as np
    import torch
    h, w = POINT_ZOO['img_hw']
    k_mat, rt, l2i = pinhole()
    frames, imgs, b2d, bval = [], [], [], []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        pts, room, boxes = room_frame(config, seed, yawed=True,
                                      shift=(-3.25, 0.8, -1.2))
        frames.append((pts, boxes, room['labels']))
        imgs.append(rng.randint(0, 256, (h, w, 3)).astype(np.float32))
        bb, bv = boxes_2d(boxes, room['labels'], l2i,
                          POINT_ZOO['boxes_2d'], rng)
        b2d.append(bb)
        bval.append(bv)
    (pts, mask), gt = batch_of(frames, dev)
    n = len(seeds)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    img = on(np.stack(imgs))
    metas = dict(bboxes_2d=on(np.stack(b2d)), bbox_valid=on(np.stack(bval)),
                 depth2img=dict(K=on(np.tile(k_mat, (n, 1, 1))),
                                Rt=on(np.tile(rt, (n, 1, 1)))))
    views = ((img[:, None] - 128.0) / 64.0,
             dict(lidar2img=on(np.tile(l2i, (n, 1, 1, 1)))))
    return (pts, mask, img, metas), (pts, mask) + views, gt


class PinnedPoints:
    """Inside the scope the point ops' choices (FPS, F-FPS, ball query,
    kNN / three-NN with its distances, VoteFusion's top-k) are kept in call
    order (``self.calls``) or, given ``calls``, replayed: each call also
    computes its own and records how many indices differ from the
    replayed ones (``self.differ``) and, for a ball query, how far the
    differing slots' points lie from the radius and from each other (the
    k-th nearest's near-ties: the quadratic expansion's rounding,
    ~1e-6 m^2 at room scale, differs between the devices), for kNN the
    largest distance difference."""
    SITES = (('msmdfusion_torch.ops.sampling', 'furthest_point_sample'),
             ('msmdfusion_torch.ops.sampling', 'combined_fps'),
             ('msmdfusion_torch.ops.sampling', 'ball_query'),
             ('msmdfusion_torch.ops.sampling', 'knn'),
             ('msmdfusion_torch.models.fusion_layers', 'topk_lower_index'))

    def __init__(self, calls=None):
        self.replay = calls is not None
        self.calls = list(calls or ())
        self.differ = []
        self.count = 0

    def __enter__(self):
        import importlib
        self._orig = []
        for mod, name in self.SITES:
            module = importlib.import_module(mod)
            fn = getattr(module, name)
            self._orig.append((module, name, fn))
            setattr(module, name, self._pinned(name, fn))
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._orig:
            setattr(module, name, fn)
        return False

    def _pinned(self, name, fn):
        import torch
        from msmdfusion_torch.ops import sampling

        def call(*args, **kwargs):
            own = fn(*args, **kwargs)
            if not self.replay:
                self.calls.append((name, own))
                return own
            kept_name, kept = self.calls[self.count]
            self.count += 1
            if kept_name != name:
                raise RuntimeError(f'replayed {kept_name}, called {name}')
            kept = moved(kept, own[0].device if isinstance(own, tuple)
                         else own.device)
            idx, keep = ((own[1], kept[1]) if isinstance(own, tuple)
                         else (own, kept))
            diff = keep != idx
            gaps = {}
            if name == 'ball_query' and bool(diff.any()):
                radius, _, xyz, centers = args[:4]
                d = sampling.square_distance(centers, xyz).sqrt()
                got = [torch.gather(d, -1, i.clamp(min=0))[diff]
                       for i in (idx, keep)]
                gaps = dict(radius=max(float((g - radius).abs().min())
                                       for g in got),
                            ties=float((got[0] - got[1]).abs().max()))
            if name == 'knn':
                gaps = dict(dist=float((own[0] - kept[0]).abs().max()))
            self.differ.append((name, int(diff.sum()), idx.numel(), gaps))
            if name == 'topk_lower_index':
                return torch.gather(args[0], -1, keep), keep
            return kept
        return call

    def summary(self):
        by = {}
        for name, n, total, gaps in self.differ:
            c = by.setdefault(name, dict(calls=0, differ=0, of=0))
            c['calls'] += 1
            c['differ'] += n
            c['of'] += total
            for k, v in gaps.items():
                key = {'radius': 'nearest_to_radius_m',
                       'ties': 'max_distance_apart_m',
                       'dist': 'max_dist2_m2'}[k]
                c[key] = (min if k == 'radius' else max)(
                    c.get(key, v), v)
        return by


def point_outputs(model, inputs):
    """The forward's and the decode's outputs, one flat dict."""
    import torch
    with torch.no_grad():
        preds = model(*inputs)
        det = model.get_bboxes(preds)
    return dict(zoo_preds(preds), **{f'det.{k}': v for k, v in det.items()})


class PinnedOutput:
    """A module's output kept (``self.out``) or, given ``out``, replaced
    by it (moved to the module's device)."""

    def __init__(self, module, out=None):
        self.module, self.out = module, out

    def __enter__(self):
        replay = self.out is not None

        def hook(module, args, output):
            if not replay:
                self.out = output
                return None
            first = output[0] if isinstance(output, (tuple, list)) \
                else output
            return moved(self.out, first.device)
        self.handle = self.module.register_forward_hook(hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()
        return False


def point_twin(label, model, inputs, pin=None):
    """The card's forward against the port's own CPU run (same weights and
    inputs): before pinning, the CPU's choices that differ from the card's
    (``PinnedPoints``); after pinning the card's into the CPU run (and the
    output of the submodule ``pin`` names, whose own difference is
    printed), every float output within TOL of its largest value, every
    integer and mask output equal."""
    import copy
    import torch
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        rec = stack.enter_context(PinnedPoints())
        held = pin and stack.enter_context(
            PinnedOutput(model.get_submodule(pin)))
        run = point_outputs(model, inputs)
    cpu = copy.deepcopy(model).cpu()
    pinned = ''
    if pin:
        with PinnedOutput(cpu.get_submodule(pin)) as own:
            point_outputs(cpu, moved(inputs, 'cpu'))
        errs = [rel_err(g.cpu(), w)[1] for g, w in zip(held.out, own.out)]
        pinned = (f'; {pin}\'s outputs (pinned) card vs CPU '
                  f'{max(errs):.3g} of max')
    with contextlib.ExitStack() as stack:
        rep = stack.enter_context(PinnedPoints(rec.calls))
        if pin:
            stack.enter_context(PinnedOutput(cpu.get_submodule(pin),
                                             held.out))
        ref = point_outputs(cpu, moved(inputs, 'cpu'))
    del cpu
    worst = {}
    for key, want in ref.items():
        got = run[key].cpu()
        if not want.is_floating_point():
            check(torch.equal(got, want), f'{label}: {key} differs between '
                  'the card and the CPU after pinning')
            continue
        worst[key] = rel_err(got, want)[1]
        check(worst[key] <= TOL, f'{label}: {key}: card vs CPU '
              f'{worst[key]:.3g} of max |ref|, above {TOL:g}')
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    print(f'{label}: the CPU\'s choices against the card\'s before '
          f'pinning: {json.dumps(rep.summary())}{pinned}; after pinning '
          f'every output within {TOL:g} of max ({len(ref)} outputs; largest '
          + ', '.join(f'{k} {v:.3g}' for k, v in top)
          + f'); {time.perf_counter() - t0:.1f} s', flush=True)


def sync_count(model, inputs):
    """The host's synchronisations with the device in one forward and
    decode (PyTorch's sync debug mode), and their sites."""
    import collections
    import warnings
    import torch
    with torch.no_grad(), warnings.catch_warnings(record=True) as got:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            model.get_bboxes(model(*inputs))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(
        f'{w.filename.rsplit("/", 2)[-1]}:{w.lineno}' for w in got
        if 'synchroniz' in str(w.message))
    return sum(sites.values()), sites.most_common(4)


def point_frame(label, model, inputs, card, frames, pin=None):
    """One counted frame (no kernel launches, overflow 0, finite boxes),
    syncs a frame, two forwards bit-equal, the CPU twin (``point_twin``),
    then ``frames`` frames by CUDA events and one frame's stages (the FPS
    loop's by CUDA events and by the host clock). Returns (ms/frame, stage
    ms)."""
    import torch
    from msmdfusion_torch import kernels
    from msmdfusion_torch.utils import overflow, timing
    model.eval()
    with torch.no_grad():
        kernels.reset_launches()
        with overflow.capture() as cap:
            det = model.get_bboxes(model(*inputs))
        launches = dict(kernels.launches)
        torch.cuda.synchronize()
    check_launches(label, launches, {})
    total = sum(cap.counters().values())
    check(total == 0, f'{label}: overflow {cap.counters()}')
    valid = det['valid']
    check(bool(torch.isfinite(det['bboxes']).all()) and int(valid.sum()) > 0,
          f'{label}: {int(valid.sum())} valid boxes')
    syncs, sites = sync_count(model, inputs)
    print(f'{label}: launches {launches} (none of the six kernels); '
          f'overflow_total {total}; {int(valid.sum())} of {valid.numel()} '
          f'proposals valid, boxes {tuple(det["bboxes"].shape)}; {syncs} '
          f'synchronisations a frame {sites}', flush=True)
    zoo_same_bits(label, model, inputs)
    point_twin(label, model, inputs, pin)
    with torch.no_grad():
        frame_ms = cuda_ms(lambda: model.get_bboxes(model(*inputs)), frames)
        with timing.record('cuda') as tr:
            model.get_bboxes(model(*inputs))
    stages = {k: round(v, 3) for k, v in tr.ms().items()}
    host = {k: round(v, 3) for k, v in tr.host_ms().items()}
    fps = stages.get('fps', 0.0)
    print(f'{label}: {frame_ms:.3f} ms/frame (CUDA events, '
          f'{frames} frames after a warm-up); stages '
          f'{json.dumps(stages)}; the FPS loop {fps:.3f} ms by CUDA events '
          f'({fps / frame_ms:.3f} of the frame), {host.get("fps", 0):.3f} '
          f'ms by the host clock [{card}]', flush=True)
    return frame_ms, stages


def point_step(label, model, inputs, gt, config, card):
    """``zoo_step`` on the point zoo: one counted step of the config's
    recipe (AdamW, its clip) with no launch of the six kernels and
    ``overflow_total`` 0, then ``ZOO['steps']`` steps timed at their
    seams. Returns ms/step."""
    step_ms, dropped, _ = zoo_step(label, model, inputs, gt, config,
                                   dict(train={}), card)
    check(not dropped, f'{label}: overflow {dropped}')
    return step_ms


def write_scannet(root, rooms, counts):
    """A ScanNet-layout set under ``root``: each room (``indoor_room``) as
    ``points/scene{i}.bin`` (6 floats a point), its instance and semantic
    masks (int64) and, per split of ``counts`` ({split: entries}), the
    info file ``scannet_infos_<split>.pkl`` whose k-th entry is room k mod
    len(rooms) (axis-aligned ``gt_boxes_upright_depth`` [K, 6], gravity
    centres). Returns {split: info path}."""
    import pickle
    root = Path(root)
    for sub in ('points', 'instance_mask', 'semantic_mask'):
        (root / sub).mkdir(parents=True, exist_ok=True)
    annos = []
    for i, room in enumerate(rooms):
        name = f'scene{i:04d}_00'
        room['points'].astype('float32').tofile(root / 'points' /
                                                f'{name}.bin')
        room['instance'].astype('int64').tofile(root / 'instance_mask' /
                                                f'{name}.bin')
        room['semantic'].astype('int64').tofile(root / 'semantic_mask' /
                                                f'{name}.bin')
        annos.append((name, dict(
            gt_num=len(room['labels']),
            name=[str(k) for k in room['labels']],
            location=room['boxes'][:, :3], dimensions=room['boxes'][:, 3:6],
            gt_boxes_upright_depth=room['boxes'][:, :6],
            index=list(range(len(room['labels']))),
            **{'class': room['labels']})))
    paths = {}
    for split, count in counts.items():
        infos = []
        for k in range(count):
            name, anno = annos[k % len(rooms)]
            infos.append(dict(
                point_cloud=dict(num_features=6, lidar_idx=name),
                pts_path=f'points/{name}.bin',
                pts_instance_mask_path=f'instance_mask/{name}.bin',
                pts_semantic_mask_path=f'semantic_mask/{name}.bin',
                annos=anno))
        paths[split] = root / f'scannet_infos_{split}.pkl'
        with open(paths[split], 'wb') as f:
            pickle.dump(infos, f)
    return paths


def write_sunrgbd(root, room, bboxes, k_mat, rt):
    """A SUN RGB-D-layout info file of one room: ``points/000001.bin``,
    yawed ``gt_boxes_upright_depth`` [K, 7] (gravity centres), the 2-D
    boxes, the image entry and the calibration (K, Rt). Returns its path."""
    import pickle
    root = Path(root)
    (root / 'points').mkdir(parents=True, exist_ok=True)
    room['points'].astype('float32').tofile(root / 'points' / '000001.bin')
    info = dict(
        point_cloud=dict(num_features=6, lidar_idx=1),
        pts_path='points/000001.bin',
        image=dict(image_idx=1, image_shape=list(POINT_ZOO['img_hw']),
                   image_path='image/000001.jpg'),
        calib=dict(K=k_mat[:3, :3], Rt=rt),
        annos=dict(gt_num=len(room['labels']),
                   name=[str(k) for k in room['labels']],
                   bbox=bboxes, location=room['boxes'][:, :3],
                   dimensions=room['boxes'][:, 3:6],
                   rotation_y=room['boxes'][:, 6],
                   gt_boxes_upright_depth=room['boxes'],
                   index=list(range(len(room['labels']))),
                   **{'class': room['labels']}))
    path = root / 'sunrgbd_infos_val.pkl'
    with open(path, 'wb') as f:
        pickle.dump([info], f)
    return path


def point_files(card, dev):
    """Phase 24 (e): VoteNet through the train CLI (``files_steps`` steps
    of the config's batch of 8 over a ScanNet-layout set of two rooms,
    (a)'s first) and the eval CLI (``files_val`` rooms, the indoor mAP at
    0.25 and 0.5), then a SUN RGB-D-layout info file of (d)'s room read
    through ``SUNRGBDDataset`` and the config's test pipeline."""
    import tempfile
    import numpy as np
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.registry import DATASETS
    label = 'point zoo (e) VoteNet from files'
    config = str(POINT_ZOO['votenet']['config'])
    cfg = load_config(config)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        rooms = [room_frame(config, SEED + i)[1] for i in range(2)]
        n_train = POINT_ZOO['files_steps'] * cfg.data.samples_per_gpu
        paths = write_scannet(cfg.data_root, rooms, dict(
            train=n_train, val=POINT_ZOO['files_val']))
        check(paths['train'] == Path(cfg.data.train.ann_file)
              and paths['val'] == Path(cfg.data.test.ann_file),
              f'{label}: wrote {paths}, the config reads '
              f'{cfg.data.train.ann_file} and {cfg.data.test.ann_file}')
        print(f'{label}: two {POINT_ZOO["room_points"]}-point rooms as a '
              f'ScanNet-layout set under {cfg.data_root} ({n_train} train, '
              f'{POINT_ZOO["files_val"]} val infos)', flush=True)
        zoo_train_cli(label, config, str(Path('work_votenet').resolve()), [],
                      POINT_ZOO['files_steps'], {}, card, dev)
        ckpt, inputs = zoo_checkpoint(config, [], dev, 'ckpt_votenet')
        zoo_eval_cli(label, config, ckpt, [], 'bbox', inputs, {}, card, dev,
                     7, keys=('mAP_0.25', 'mAP_0.50', 'mAR_0.25',
                              'mAR_0.50'))

        sun = str(POINT_ZOO['imvotenet']['config'])
        scfg = load_config(sun)
        _, room, _ = room_frame(sun, SEED, yawed=True)
        k_mat, rt, l2i = pinhole()
        bboxes = np.zeros((len(room['labels']), 4), np.float32)
        path = write_sunrgbd(scfg.data_root, room, bboxes, k_mat, rt)
        ds = DATASETS.build(dict(scfg.data.test, ann_file=str(path)))
        sample = ds.sample(0, np.random.RandomState(SEED))
        ann = ds.get_ann_info(0)
        bottom = room['boxes'].copy()
        bottom[:, 2] -= bottom[:, 5] / 2
        check(sample['points'].shape == (scfg.num_points, 4)
              and np.array_equal(ann['gt_bboxes_3d'], bottom)
              and np.array_equal(ann['gt_labels_3d'], room['labels']),
              f'{label}: SUNRGBDDataset read {sample["points"].shape}, '
              f'boxes {ann["gt_bboxes_3d"][:2]}')
        print(f'point zoo (e) SUN RGB-D layout: {path.name} read through '
              f'SUNRGBDDataset: points {sample["points"].shape}, '
              f'{len(ann["gt_labels_3d"])} yawed boxes equal to the room\'s '
              '(bottom centres)', flush=True)


def point_zoo(card, dev):
    """Phase 24 (see ``POINT_ZOO``): (a)-(e). Returns {path: launches}."""
    import numpy as np
    import torch
    from msmdfusion_torch.config import load_config
    from msmdfusion_torch.models.fusion_layers import project_points_to_image
    from msmdfusion_torch.utils.calibrate import calibrate_norms
    from msmdfusion_torch.utils.synth_scene import lidar_scene, scene_gt
    paths, summary = {}, {}

    def setup(name, inputs):
        t0 = time.perf_counter()
        model = zoo_model(POINT_ZOO[name]['config'], dev)
        with torch.no_grad():
            calibrate_norms(model, *inputs)
        print(f'point zoo {name}: {POINT_ZOO[name]["config"].name} built, '
              f'{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M '
              f'parameters, norms calibrated in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        return model

    def rooms(name, seeds):
        return batch_of([(p, b, r['labels']) for p, r, b in (
            room_frame(POINT_ZOO[name]['config'], s) for s in seeds)], dev)

    # (a) VoteNet, (b) H3DNet on the same ScanNet-like room
    one, one_gt = rooms('votenet', (SEED,))
    two, two_gt = rooms('votenet', (SEED, SEED + 1))
    for key, name in (('a', 'votenet'), ('b', 'h3dnet')):
        label = f'point zoo ({key}) {name}'
        model = setup(name, one)
        frame = point_frame(label, model, one, card, POINT_ZOO[
            'frames' if key == 'a' else 'other_frames'])
        step = point_step(f'{label} train', model, two, two_gt,
                          POINT_ZOO[name]['config'], card)
        summary[name] = dict(ms_frame=round(frame[0], 3),
                             ms_step=round(step, 3), stages=frame[1])
        paths[name] = {}
        del model
        torch.cuda.empty_cache()
    del one, two

    # (c) SSD3DNet on phase 22's KITTI frame, 16,384 points
    cfg = load_config(str(POINT_ZOO['ssd3d']['config']))
    pts, objects = lidar_scene(np.random.RandomState(SEED),
                               ZOO['kitti_points'], cfg.point_cloud_range)
    boxes, labels, valid = scene_gt(objects)
    take = np.random.RandomState(SEED).choice(len(pts), cfg.num_points,
                                              replace=len(pts) <
                                              cfg.num_points)
    frame_c = (pts[take, :4], boxes[valid][:, :7], labels[valid] * 0)
    kitti, kitti_gt = batch_of([frame_c], dev)
    kitti2, kitti2_gt = batch_of([frame_c, frame_c], dev)
    label = 'point zoo (c) ssd3d'
    model = setup('ssd3d', kitti)
    frame = point_frame(label, model, kitti, card, POINT_ZOO['other_frames'])
    step = point_step(f'{label} train', model, kitti2, kitti2_gt,
                      POINT_ZOO['ssd3d']['config'], card)
    summary['ssd3d'] = dict(ms_frame=round(frame[0], 3),
                            ms_step=round(step, 3), stages=frame[1])
    paths['ssd3d'] = {}
    del model, kitti, kitti2
    torch.cuda.empty_cache()

    # (d) ImVoteNet: the cue path (frame and step), the image path (frame)
    config = POINT_ZOO['imvotenet']['config']
    cues, views, gt = imvote_frame(config, (SEED,), dev)
    cues2, _, gt2 = imvote_frame(config, (SEED, SEED + 1), dev)
    label = 'point zoo (d) imvotenet'
    model = setup('imvotenet', cues)
    width = model.backbone.out_channels + 128        # 384 at full width
    check(tuple(model.bbox_head.vote_out.weight.shape) == (3 + width, width),
          f'{label}: vote_out {tuple(model.bbox_head.vote_out.weight.shape)}')
    with torch.no_grad():
        seeds = model.backbone(*cues[:2])['fp_xyz'][0]
        _, ok = project_points_to_image(seeds, views[3]['lidar2img'][0, 0],
                                        POINT_ZOO['img_hw'])
    print(f'{label}: the head {width} wide (vote_out {3 + width}); '
          f'{int(ok.sum())} of {len(ok)} seeds on the '
          f'{POINT_ZOO["img_hw"]} image; '
          f'{int(cues[3]["bbox_valid"].sum())} valid 2-D boxes of '
          f'{POINT_ZOO["boxes_2d"]}', flush=True)
    frame = point_frame(f'{label} cues', model, cues, card,
                        POINT_ZOO['other_frames'])
    step = point_step(f'{label} cues train', model, cues2, gt2, config, card)
    # the dense image branch's own rounding (cuDNN off in fp32 against the
    # CPU's convs) moves the head by ~2e-3 of max: the CPU run takes the
    # card's FPN maps, their difference printed
    image = point_frame(f'{label} image backbone', model, views, card,
                        POINT_ZOO['other_frames'], pin='img_neck')
    summary['imvotenet'] = dict(ms_frame=round(frame[0], 3),
                                ms_step=round(step, 3), stages=frame[1],
                                image_ms_frame=round(image[0], 3),
                                image_stages=image[1])
    paths['imvotenet'] = {}
    del model, cues, cues2, views
    torch.cuda.empty_cache()

    # (e) from files
    point_files(card, dev)
    print(f'point zoo: {json.dumps(summary)} [{card}]', flush=True)
    print('point zoo: launches of the six kernels on every path '
          + json.dumps(paths), flush=True)
    return paths


def report(phases, card, paths=None):
    """The rows kernels' sums lines and the ``kernels`` line of the
    flagship's phases (``flagship_phases``); each entry also carries
    ``path_launches``, its launches on the paths of ``paths`` ({path:
    {kernel: launches}}, phase 23's) that launched it."""
    # the rows kernels' sums where the kernels line does not hold them: the
    # packed engine's calls, which also write the tap-hit masks, and the
    # one-hot step's backward
    for label, recs, masked in (
            ('rows_affine with masks, packed bf16 frame',
             phases[2][0]['rows_affine'], True),
            ('rows_queries with masks, packed bf16 step',
             phases[3][0]['rows_queries'], True),
            ('rows_affine, one-hot step backward',
             phases[5][0]['rows_affine_bwd'], False)):
        check(all(r['masked'] == masked for r in recs),
              f'{label}: calls with{"out" if masked else ""} masks')
        print(f'{rows_sums(label, recs)} [{card}]', flush=True)
    # each kernel's records and launches from the first phase that has
    # its records and launched it on its main path (the exact kernels run
    # the x3 ones' calls in phases 4 and 5, on launches of 0 there: the
    # conv's launches come from phase 4's frame on highest, conv_dw's from
    # the one-hot step, which runs it)
    picked = {}
    names = list(KERNEL_INFO) + list(DIRECTIONS)
    for recs, launches in phases:
        for name in recs:
            if name in names and name not in picked and launches.get(name):
                picked[name] = (recs[name], launches)
    check(set(picked) == set(names),
          f'kernels never checked: {sorted(set(names) - set(picked))}')
    summary = [kernel_summary(name, *picked[name]) for name in names]
    for entry in summary:
        entry['path_launches'] = {p: n[entry['name']] for p, n in
                                  (paths or {}).items()
                                  if n.get(entry['name'])}
    print(json.dumps({'kernels': summary}), flush=True)


CARD_TESTS = ('tests/test_torch_rows_card.py',
              'tests/test_torch_conv_bf16_card.py',
              'tests/test_torch_conv_x3_card.py',
              'tests/test_torch_match_conv_card.py',
              'tests/test_torch_conv_dw_card.py',
              'tests/test_torch_nn_argmin_card.py',
              'tests/test_torch_conv_ffma_card.py',
              'tests/test_torch_zoo_card.py',
              'tests/test_torch_indoor_card.py')


def card_tests():
    """Phase 2b: the kernels' card tests (JAX-free, marked ``cuda``), in a
    child process that the phase waits for; fails if any test fails or
    skips."""
    out = subprocess.run(
        [sys.executable, '-m', 'pytest', '--noconftest', '-p',
         'no:cacheprovider', '-m', 'cuda', '-q', '-rs', *CARD_TESTS],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ''
    print(f'card tests {" ".join(CARD_TESTS)}: {tail}', flush=True)
    check(out.returncode == 0 and 'skipped' not in tail,
          f'card tests failed:\n{out.stdout[-4000:]}\n{out.stderr[-2000:]}')


def main():
    if not (ROOT / 'msmdfusion_torch' / '__init__.py').is_file():
        print('chip_smoke: msmdfusion_torch/ not found beside this script',
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False: this script '
              'needs an NVIDIA card', file=sys.stderr)
        return 1
    from msmdfusion_torch import kernels
    from msmdfusion_torch.utils.calibrate import calibrate_norms

    # 1. environment
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)} x '
          f'{torch.cuda.device_count()}', flush=True)

    # 2. build
    lap = phase_laps()
    t0 = time.perf_counter()
    built = kernels.build()
    build_s = time.perf_counter() - t0
    for name, (secs, log) in built.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if 'registers' in ln or 'spill' in ln]
        print(f'build {name}: {secs:.1f} s; ' + ' | '.join(ptxas),
              flush=True)
    for name in KERNEL_INFO:
        kernels.entry_point(name)
    print(f'build: {len(built)} sources of {len(KERNEL_INFO)} kernels in '
          f'{build_s:.1f} s (parallel nvcc)', flush=True)
    card_tests()
    lap('2 (build and card tests)')

    # 3. TransFusion-L (kept for phase 11, its weights for phase 14)
    t0 = time.perf_counter()
    tl_model = build_model(dev, max_voxels=TL['max_voxels'])
    tl_inputs, tl_gt = make_points(tl_model, TL['n_points'], dev)
    calibrate_norms(tl_model, *tl_inputs)
    print(f'TransFusion-L setup: model + {TL["n_points"]} points + norms in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    drive('TransFusion-L', tl_model, tl_inputs, TL, card,
          reps=dict(kernel=10, frame=5))
    tl_kept = keep_tl(tl_model, tl_inputs)
    lap('3 (TransFusion-L)')

    # 4. MSMDFusion
    t0 = time.perf_counter()
    model = build_flagship(dev)
    inputs, gt = make_scene(model, FLAGSHIP['shape'], dev)
    calibrate_norms(model, *inputs)
    flag_kept = kept(model, inputs)
    print(f'MSMDFusion setup: model + realistic scene + norms in '
          f'{time.perf_counter() - t0:.1f} s; foreground points '
          f'{int(inputs[3]["fg_mask"].sum())}, real pixels '
          f'{int(inputs[3]["fg_real_mask"].sum())}', flush=True)
    phases = flagship_phases(model, inputs, gt, card)
    lap('4-10 (MSMDFusion setup and phases 4-10)')

    tl_train_step(tl_model, tl_inputs, tl_gt, card)
    del tl_model, tl_inputs, tl_gt
    torch.cuda.empty_cache()
    lap('11 (TransFusion-L train)')
    stage2_train_step(model, inputs, gt, card)
    lap('12 (stage-2 train, LiDAR encoders frozen)')
    phases += bf16_train_steps(model, inputs, gt, card)
    lap('13 (bf16-compute train steps)')
    del model, inputs, gt
    torch.cuda.empty_cache()

    lc, lc_inputs, lc_gt = lc_inference(tl_kept, card)
    lap('14 (TransFusion-LC)')
    lc_train_step(lc, lc_inputs, lc_gt, card)
    del lc, lc_inputs, lc_gt
    torch.cuda.empty_cache()
    lap('15 (TransFusion-LC train, image branch frozen)')
    waymo_phases(card, dev)
    lap('16 (Waymo TransFusion-L and LC)')
    dist = []

    def then(files):
        lap('17 (the eval and train CLIs on files)')
        dist.extend(dist_clis(files))
        lap('18 (c, d: the CLIs over 2 ranks)')
        gt_paste(card, dev, files['root'], files['ann'])
        lap('19 (GT paste: the database and the stage-1 train CLI from '
            'files)')
        tool_files(card, dev, files)
        lap('21 (f: publish_model, visualize_results and analyze_logs on '
            'phase 17\'s files)')
        zoo_files(card, dev, files)
    entry_points(card, dev, then=then)
    lap('22 (f: CenterPoint through the eval and train CLIs on phase 17\'s '
        'files)')
    dist += dist_steps(card, dev)
    lap('18 (a, b: the flagship step over a process group)')
    print('dist: ' + ' | '.join(dist), flush=True)
    waymo_files(card, dev)
    lap('20 (Waymo from files: the train and eval CLIs)')
    offline_tools(card, dev, flag_kept, tl_kept)
    del flag_kept
    lap('21 (a-e: FLOP counts, the fused frame, the microbench, the speed '
        'CLI, the trace summary)')
    zoo(card, dev)
    second_files(card, dev)
    lap('22 (a-e, g: the single-stage zoo; SECOND through the CLIs on '
        'KITTI-format files)')
    paths = two_stage(card, dev, tl_kept)
    del tl_kept
    lap('23 (Part-A2, MVXNet, test-time augmentation)')
    point_zoo(card, dev)
    lap('24 (the point-based zoo: VoteNet, H3DNet, SSD3DNet, ImVoteNet; '
        'VoteNet through the CLIs from files)')

    report(phases, card, paths)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
