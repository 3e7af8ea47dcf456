#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

Drives the port's paths at the repo's bench geometries, with random
weights from seeds: serving — paged-KV continuous-batching decode of the
transformer LM (GPT-2-small: L12, hidden 768, 12 heads, vocab 32768,
T 1024; 8 slots, page 64) — training the same LM — ``get_symbol`` ->
``ShardedTrainer`` -> ``init_state`` -> ``step`` in f32 at batch 8 —
training the DLRM-style recommender over the sparse embedding plane —
``ShardedEmbedding`` -> ``recommender_state`` -> ``make_recommender_step``
at the bench's 4 tables x 100,000 x 16, batch 4096, and at a Criteo shape
of 26 tables x 1,000,000 x 64, batch 8192 — and training the LM through
the classic API — ``mx.io.NDArrayIter`` -> ``mx.mod.Module(net,
compression_params={"type": "2bit", ...})`` -> ``fit(kvstore=
mx.kv.create("device"))`` — and the imperative API over the same LM's
parameters — ``mx.nd`` arrays from ``mx.random``, a user's CUDA kernel
compiled by ``mx.rtc.CudaModule`` and launched over them,
``nd.save`` / ``nd.load`` — and training ResNet-50 at bench.py's
configuration through ``ShardedTrainer`` (after small ResNets and a
conv net's ``Module.fit`` on the card against the CPU) — and bench.py's
own bf16 configuration, the LM (on the flash kernels in bf16) and
ResNet-50 through ``sgd_step_fn`` and ``build_step_auto_layout`` — and
MXNet's float16 recipe: ResNet-50 built in float16 through ``Module.fit``
with multi-precision SGD and a 2-bit ``KVStore("device")``, and the LM
through ``ShardedTrainer(param_dtype="float16")`` with a dynamic loss
scale on the flash kernels in f16 — and the recommender on bf16 tables,
the optimizers of ``mxnet_tpu_torch.optimizer`` through ``Module.fit``
(the full-width LM with Adam) and a checkpoint resumed — and the LM over
length buckets through ``BucketingModule.fit``, with remat — and the LM
and ResNet-50 through Gluon (``autograd.record``, a hybridized
``SymbolBlock`` or model-zoo net, ``gluon.Trainer``) — and the
recurrent stack: the large LSTM word LM through ``gluon.rnn.LSTM`` and
a bucketed ``FusedRNNCell`` LM, both on the ``RNN`` op's cuDNN path — and
the SSD detector through ``Module.fit`` at 300x300 on the greedy-NMS
kernel, the R-CNN and R-FCN detection ops and five more conv nets — and
sparse storage: the wide-embedding loop of lazy SGD over
``row_sparse_pull`` / ``push`` at the Criteo shape, CSR batches from
``LibSVMIter`` at Avazu's width, and the SparseEmbedding classifier
through ``Module.fit`` with ``sparse_row_id_fn`` — and
holds every hand-written kernel of those paths against its plain PyTorch
version on the card.
Phases, in order:

1. build the kernels from ``mxnet_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel), identify the card, and check the SASS of the
   3xTF32 kernels (the three f32 flash kernels and both instantiations
   of the quantized matmul) for TF32 ``HMMA`` instructions, and of the
   three 16-bit flash kernels for ``HMMA.16816`` of their element type
   (bf16, f16) and no other (``cuobjdump -sass``);
2. each kernel against its plain version at the shapes the decode step
   gives it (decode attention at the step's mix of lengths and at the
   full cache, 8 x 1024 tokens), two launches bit-equal, with its time,
   its bound (the least
   time for the bytes it must move at 3.35 TB/s, or its operations at the
   f32 peak; for the quantized matmul also at the TF32 tensor-core peak
   with two MMAs per product), the plain version's time and one PyTorch
   library call's time as a yardstick;
3. a small decode step and the full-width step on the card against the
   same steps on the CPU;
4. serve f32: a DecodeEngine over ``get_decode_step(init_decode_params
   (cfg, seed=0))``, 16 requests of mixed lengths with one
   higher-priority arrival into a full batch, continuous-vs-serial token
   parity, step time and tokens/s beside the ``decode_step_model``
   roofline;
5. serve int8 and int4 exports of the same model;
6. the three flash-attention kernels (forward with the logsumexp, dQ,
   dK/dV) against their plain versions at the training shape (B8 T1024
   H12 D64, causal), a ragged T 1000 and a non-causal case, with times,
   bounds (f32 and 3xTF32) and the ``scaled_dot_product_attention``
   yardstick; before them two launches of each bit-equal, and inputs on
   which 1xTF32 einsums exceed the tolerances that the kernels meet;
7. one training step at full width and depth 2 (batch 2) on the card
   against the same step on the CPU (plain versions) from the same state;
8. training at full width: L12, batch 8, one warm-up and five timed
   steps, tokens/s, device busy time and idle share, peak memory, the
   share of the f32 peak, and the cross-entropy before and after;
9. the embedding gather and scatter (add and set) kernels against their
   plain versions, exactly, at the recommender path's shapes (timed, with
   bounds and the ``index_select`` / ``index_copy_`` / ``index_add_``
   yardsticks) and at ragged ones (D 13 and 1, n 1, duplicates, the ids
   0 and rows-1, pads >= rows); then the step's two grouped gathers at
   both geometries (the lookup over every table: 4 and 26 segments; the
   update over every table's weight and momentum rows: 8 and 52), timed
   beside one launch per table and one ``index_select`` per table;
10. two recommender steps on the card against the same steps on the CPU
    from one state (4 tables x 1000 x 16, batch 512);
11. the recommender at the bench geometry (3 warm-up and 20 timed steps)
    and the Criteo shape (2 + 5): examples/s, step time, device busy time
    and idle share, peak memory, the loss before and after on the
    repeated batch, and one step under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation
    before the loss is read);
12. the two-bit gradient compression kernel against its plain version,
    exactly, with one segment at every shape the LM's 198 keys give it
    (timed, with bounds) and at n 1 and 1023, a tail (25,165,827),
    misaligned views, threshold 0.3 at f32(0.3) and its nextafter
    neighbours, NaN and +-inf; then over all 198 keys in one grouped call
    (timed against the bound and one launch per key);
13. ``Module.fit`` for 3 steps through a compressing ``KVStore("device")``
    on the card and on the CPU from the same parameters (2 layers,
    hidden 64, T 64): every key's q + new residual, q exactly except
    near +-t (counted), the weights, and one grouped kernel launch per
    push;
14. ``Module.fit`` of the full-width LM at batch 8 through a compressing
    ``KVStore("device")`` on 16 numpy-seeded sequences (2 batches per
    epoch): 2 warm-up and 12 timed steps (CUDA events at each batch end),
    tokens/s, host time in ``update()``, B7's launches and device time,
    device idle share and kernels per step from one profiled step, peak
    memory, phase 8's ``ShardedTrainer`` step beside it, the perplexity
    falling over the timed epochs, and the fired share counted in a last
    epoch after the timed and profiled steps, which carry no counting.
15. ``rtc.CudaModule`` (the port of the last Pallas site, the JAX
    package's ``rtc.TPUModule``): the user kernels of
    ``mxnet_tpu_torch/csrc/rtc_kernels.cu`` compiled by NVRTC for
    ``sm_90a`` with ``--fmad=false`` (compile ms printed), the five of
    ``tests/test_rtc.py`` and the reference's docstring launched at
    (8, 128) and (32768, 768) f32 and held to their plain versions
    exactly (one ``--fmad=true`` build's difference beside them), timed
    with bounds and library yardsticks; the host time per launch; and a
    CPU context, a dtype mismatch, a non-contiguous array, a 2048-thread
    block and a source that does not compile, each raising MXNetError;
16. every op case of the five general op modules (``tests/
    torch_cases.py``, with the variants at ids out of range, saturating
    casts, NaN, integer remainder by zero and integer dtypes) through
    ``mx.nd`` on the card against the CPU, and variadic ops (concat,
    stack, add_n, khatri_rao) in a Symbol graph;
17. the imperative path at full width: the LM's 198 parameter arrays
    (136.2 M) made with ``mx.random.seed(0)`` and ``nd.random.normal``
    on the card, gradients and momenta likewise, NDArray arithmetic,
    ``nd.sum`` and ``nd.dot``, 5 steps of momentum SGD each launching the
    user's ``CudaModule`` kernel ``sgd_mom`` once per array, held against
    ``nd.sgd_mom_update`` on copies (1e-6 of each tensor's largest
    magnitude), device and host ms per step against the bound, peak
    memory, then ``nd.save`` of the weights (545 MB) and ``nd.load``
    back, bit for bit;
18. conv nets on the card against the CPU from one state: two
    ``ShardedTrainer`` steps of the cifar ResNet-20 (12x12, batch 4; every
    tensor within 1e-3 of its largest change) and of the imagenet branch's
    7x7 stride-2 stem and padded max pool at depth 18 (64x64, batch 2;
    norm-wise within 1e-2, since its ``bn0_gamma`` gradient is
    ill-conditioned and a ReLU or max-pool tie can go another way on the
    two devices: ``tools/convnet_gaps.py``), NCHW and NHWC; one training
    forward and gradient of the bottleneck ResNet-50 (40x40, batch 2);
    three ``Module.fit`` batches of the cifar ResNet-20, its BatchNorm
    statistics through the Module's aux path;
19. ResNet-50 at bench.py's configuration (224x224, 1000 classes, batch
    32, f32, lr 0.1, momentum 0.9, wd 1e-4, data from a seed on the
    card), ``cudnn.benchmark`` on and TF32 off: 2 warm-up and 10 timed
    steps in NCHW, 2 and 5 in NHWC; images/s, step ms and spread, device
    busy time, idle share and time by group (conv forward, data
    gradient, weight gradient, batch norm, elementwise, SGD) from one
    profiled step, peak memory, the share of the f32 peak from the
    graph's FLOP count, the cross-entropy of the repeated batch before
    and after; then the training check (``RESNET_CHECK``: a fresh trainer
    at lr 0.01 must lower the cross-entropy by a margin in 8 steps; the
    lr 0.1 loop's end spikes by chance).  The path runs on cuDNN and
    cuBLAS: no hand-written kernel launches there;
20. the flash kernels in bf16 (B9: the three kernels' bf16 entry points)
    against their plain versions at the LM's training shape (B8 T1024
    H12 D64, causal; timed, with bounds at the bf16 tensor rate and the
    bf16 ``scaled_dot_product_attention`` forward, backward alone and
    forward+backward as yardsticks, the backend that ran named) and at
    ragged shapes (T 1000 D 32, T 777 D 128, a non-causal T 520), within
    one bf16 step of each element plus the f32 kernels' tolerances, two
    launches bit-equal;
21. bench.py's LM configuration in bf16 (``param_dtype="bfloat16"``):
    one step of the L2, hidden 64, T 64 LM on the flash path on the card
    against the CPU, each tensor within 3x the CPU's own bf16 rounding
    gap (its bf16 step against its f32 step from the same weights); then
    the full-width LM at batch 8 through ``sgd_step_fn`` (one step under
    ``set_sync_debug_mode("error")``) and ``build_step_auto_layout`` in
    bench.py's loop shape (3 warm-up, 20 timed steps, the loss read once
    at the end): tokens/s, per-step spread from CUDA events, device idle
    share and time by group from 3 profiled steps (B9's share of the
    step among them), peak memory, 12 launches of each B9 kernel per step
    and none of the f32 ones, the cross-entropy of the repeated batch
    falling by ``LM_CE_MARGIN``;
22. bench.py's ResNet-50 configuration in bf16 (``dtype="bfloat16"``,
    ``param_dtype="bfloat16"``, NCHW): one step of the cifar ResNet-20 on
    the card against the CPU (as in 21), then ResNet-50 through
    ``build_step_auto_layout`` (its 53 convolution weights and their
    momentum channels-last) and ``sgd_step_fn`` in bench.py's loop
    shape: images/s, spread, idle share, time by group, peak memory, the
    cross-entropy before and after, and the training check of 19 in
    bf16 through each step builder; no hand-written kernel launches
    there;
23. the two-bit kernel in f16, bf16 and f64 (B10) against its plain
    version, exactly: ResNet-50's push (157 keys, misaligned views, the
    threshold's neighbours, NaN, +-inf) in each dtype with one launch,
    a push of mixed dtypes (one launch per dtype), a strided gradient;
    the f16 push timed with its bound, and five one-segment shapes;
24. float16 through ``Module.fit``: the cifar ResNet-20 (28x28, two
    batches, multi-precision SGD through the store) on the card against
    the CPU within 3x the CPU's own f16 gap; then ResNet-50 built with
    ``dtype="float16"`` at train_imagenet.py's benchmark configuration
    (128 seeded images, shuffled, lr 0.1 under its MultiFactorScheduler,
    momentum 0.9, wd 1e-4, ``multi_precision``, Xavier gaussian/in/2,
    Accuracy, CrossEntropy and top-5 accuracy) through a 2-bit
    ``KVStore("device")``: images/s, host ms in ``update()``, one B10
    launch per step and its device time, the fired share, busy time,
    idle share, peak memory; then its training check
    (``MODULE_CHECK``);
25. the flash kernels in f16 (B9 f16) as 20 does in bf16, within one f16
    step, plus a case with dO at a loss scale's size (largest |dO| 6e4);
26. the LM in float16 (``param_dtype="float16"``, dynamic loss scale
    from ``F16_LOSS_SCALE``): one step of the small LM card vs CPU
    within 3x the CPU's own f16 gap, then the full-width LM through
    ``sgd_step_fn`` and ``build_step_auto_layout`` as 21 runs it: 12
    launches of each B9 f16 kernel per step, the loss scale at the end,
    no step skipped (the guard's device streak of good steps equals the
    steps taken), the cross-entropy falling by ``LM_CE_MARGIN``;
27. the embedding gather and scatter at the table's dtype (B11: bf16,
    f16, f64) against their plain versions, exactly, with inexact tables
    and payloads (each add rounds to the dtype, so the order shows) at
    ragged shapes (D 13, 7 and 1, n 1, runs of duplicates, ids 0 and
    rows-1, pads >= rows) and at the recommender's (timed, with the
    bytes bound and ``index_select`` / ``index_copy_`` / ``index_add_``
    in the same dtype), two launches bit-equal; then the bf16
    recommender's update gather, bf16 tables with their f32 momentum in
    one launch, at both geometries;
28. the recommender on bf16 tables (``ShardedEmbedding(dtype=
    "bfloat16")``): two steps on the card against the CPU (4 x 1000 x 16,
    batch 512; tables within one bf16 step), then the bench geometry (3
    + 20 steps) and the Criteo shape (2 + 5) as phase 11 runs them, two
    grouped gathers per step and a bf16 and an f32 scatter per table,
    beside phase 11's f32 steps;
29. the optimizers through ``Module.fit``: each of Adam, NAG, RMSProp
    (both forms), AdaGrad, AdaDelta, Adamax, Nadam, Ftrl, FTML, Signum,
    SGLD, DCASGD and LBSGD (LARS) for three steps of the small LM on the
    card, every update held to the CPU's replay of the same call (SGLD:
    its noise N(0, lr)); the full-width LM with Adam through a 2-bit
    ``KVStore("device")`` (tokens/s, host ms in ``update()``, one B7
    launch per step, the perplexity falling); and checkpoint and resume
    on the card: ``module_checkpoint(..., save_optimizer_states=True)``,
    ``Module.load(prefix, 1, load_optimizer_states=True)`` and
    ``fit(begin_epoch=1)`` equal to the uninterrupted ``fit`` bit for bit,
    with SGD and with Adam;
30. ``BucketingModule`` and remat: the three f32 flash kernels against
    their plain versions at T 256 and 512 (B8 H12 D64 causal, phase 6's
    tolerances), timed with bounds and SDPA; (a) the parity LM over
    buckets 16 / 32 / 64 (``flash_min_seq`` 16, batch 4,
    ``BucketSentenceIter`` on seeded sentences) through two epochs of
    ``BucketingModule.fit`` and ``KVStore("device")`` on the card and
    on the CPU, every parameter within 1e-3 of its largest update; (b)
    the full-width LM over buckets 256 / 512 / 1024 (96 seeded
    sentences, batch 8, SGD lr 1e-4, ``Perplexity(ignore_label=0)``,
    2 epochs): per bucket the median step ms and real and padded
    tokens/s, host ms in ``switch_bucket``, idle share of a profiled
    1024 step, peak memory, the perplexity falling, and every bucket's
    parameter and gradient tensors at the anchor's ``data_ptr``; (c)
    one ``forward_backward`` of the 1024 bucket under each remat policy
    and under ``MXNET_TPU_FLASH_BWD=remat``: peak memory, ms, launches,
    gradients against ``none`` (1e-5 of each tensor's largest
    magnitude; the einsum backward 5e-2, beside the flash and einsum
    backward's distance from float64), ``full``'s peak below
    ``none``'s;
31. autograd and Gluon: (a) ``nd.contrib.fused_attention`` under
    ``autograd.record`` at (8, 1024, 12, 64) f32 with q, k and v marked
    (``attach_grad``), then only q (``mark_variables``): the output and
    the gradients against autograd through the plain einsum on the card
    (phase 6's tolerances), one launch each of B1, B2a and B2b per
    recording; (b) the LM's logits (``get_internals()["head_output"]``)
    as a hybridized ``gluon.SymbolBlock`` trained by
    ``SoftmaxCrossEntropyLoss``, ``autograd.record``, ``backward`` and
    ``gluon.Trainer("sgd", kvstore="device")``: one step of the small LM
    (L2, hidden 128, T 1024, vocab 1000, batch 2) on the card against the
    CPU (phase 7's tolerances; the key weights norm-wise) and its
    gradients under ``set_backward_mirror("dots")`` equal to ``none``'s,
    then the full-width LM with phase 8's weights (2 warm-up and 10
    timed steps, CUDA events at each step's end): tokens/s beside phase
    8's ``ShardedTrainer``, host ms in ``Trainer.step``, the idle share
    of a profiled step, peak memory with the loss freed each step and
    kept until the next, 12 launches of each flash kernel per step, the
    cross-entropy falling; (c) one hybridized ``resnet18_v1`` step
    (32x32, batch 4) card against CPU (phase 18's norm-wise tolerance),
    then ``model_zoo.vision.resnet50_v1`` at 224x224, batch 32, f32
    through ``Trainer``: images/s over 5 timed steps, idle share, peak
    memory, and phase 19's training check on a fresh net at lr 0.01;
32. the recurrent stack: (a) Zaremba et al.'s large LSTM word LM, the
    tied 1500-unit configuration of MXNet's
    example/gluon/word_language_model (``nn.Embedding(10000, 1500)`` ->
    ``Dropout(0.65)`` -> ``rnn.LSTM(1500, 2 layers, dropout 0.65)`` ->
    ``Dropout(0.65)`` -> ``nn.Dense(10000)`` on the encoder's weight, 51 M
    parameters) through Gluon at bptt 35, batch 32, f32: one step with
    dropout 0 on the card against the CPU's plain loop from the same
    weights (loss within 1e-5, each parameter's update norm-wise within
    1e-3), then ``autograd.record``, ``backward``, ``clip_global_norm(
    grads, 0.2 x 35 x 32)`` and ``Trainer("sgd", lr 1.0).step(32)`` with
    the hidden state detached between Zipf-distributed token batches: 3
    warm-up and 20 timed steps (ms, tokens/s, host ms in
    ``Trainer.step``, idle share, cuDNN's RNN time, peak memory, every
    forward through cuDNN and none through the plain loop), the held-out
    batch's perplexity from an evaluation pass without ``record``, the
    training check (a fresh model at ``WORD_LM_CHECK_LR``: the
    cross-entropy falls by ``WORD_LM_CE_MARGIN``, the held-out
    perplexity falls), and the two LSTM layers alone against
    ``torch.nn.LSTM`` with cuDNN-flattened weights, with the copies the
    packed blob and Gluon's per-gate Parameters cost; (b) the default
    configuration of MXNet's example/rnn/bucketing/
    cudnn_lstm_bucketing.py: ``FusedRNNCell(200, 2 layers, lstm)``
    unrolled per bucket (10-60) in a ``BucketingModule``, SGD lr 0.01 wd
    1e-5 through ``KVStore("device")``, ``Perplexity``: ms per step per
    bucket; then ``save_rnn_checkpoint``, the unfused ``LSTMCell`` stack
    from the file, and both scored on held-out buckets (perplexity within
    1e-4, one batch's softmax within 1e-5);
33. the ``RNN`` op on cuDNN against its plain loop on the card in every
    mode, 1-2 layers, 1-2 directions, with and without
    ``state_outputs``, f32 and f64, outputs and gradients; a gradient
    under ``autograd.record(train_mode=False)``; the dropout's keep share
    and its draws from ``mx.random.seed``; bf16 through cuDNN in f32; the
    14 linalg ops (28 names) on 64 x 256 x 256 SPD matrices in f32 and
    f64 card against CPU, timed; the spatial ops card against CPU, and
    ``Correlation`` at FlowNetC's shape, timed;
34. SSD (``models/ssd.get_symbol_train(num_classes=20, nms_thresh=0.45,
    nms_topk=400)``): one ``Module`` step at 64x64, batch 4, on the card
    and on the CPU from one state (losses within 1e-4; every update
    within 1e-3 of its tensor's largest change, or the CPU's own, from
    the float64 step), and MultiBoxDetection on the card fed the CPU
    forward's heads equal to the CPU's; then ``Module.fit`` at 32 x 3 x
    300 x 300 f32 (30,120 anchors, example/ssd/train.py's SGD: lr 0.002,
    momentum 0.9, wd 5e-4) over 128 seeded scenes for 4 epochs: images/s
    from CUDA events at each batch end, spread, one NMS launch per step,
    idle share and time by group (convolutions, batch norm, NMS, the
    rest) of one profiled step, peak memory; the NMS kernel on the step's
    own sorted boxes equal to its plain version, rerun equal, timed with a
    cold L2 beside its bound, the chain floor (kept boxes of the longest image
    x one measured barrier round trip x waves), the exchange floor (the
    steps it needs at least x one measured round of its exchange x
    waves) and its time at each cluster size; the cross-entropy of a
    fresh Module falling on one repeated batch (``SSD_CHECK``); the
    deploy symbol's forward at batch 32;
35. the detection ops at Faster R-CNN's and R-FCN's sizes card vs CPU,
    timed: MultiProposal on (2, 18, 38, 63) with 9 anchors (6000 -> 300,
    one NMS launch), and its NMS call alone on the card (equal to the
    plain version, timed, with its bound, chain floor and time at each
    cluster size), ROIPooling of 300 ROIs at 7x7 on (1, 512, 38, 63),
    PSROIPooling with output_dim 21 and k 7, DeformableConvolution 3x3 on
    (1, 256, 38, 63); then ResNet-50 v1, ResNeXt-50 32x4d, MobileNet,
    GoogLeNet and Inception-v4 at a small size card vs CPU (a training
    forward per tensor, Inception-v4's up to reduction B; a predict
    forward and gradient) and one ``ShardedTrainer`` step each at batch 32 and 224x224
    (Inception-v4 299x299), images/s;
36. sparse storage: (a) example/sparse/linear_classification.py's loop
    at the Criteo shape (26 keys of (1,000,000, 64) f32 in
    ``kv.create("device")``, lazy momentum SGD, batch 8192, Zipf ids):
    ``row_sparse_pull`` of each key's ids, ``embedding_grad``, one list
    ``push``; three steps at 100,000 rows card vs the CPU's plain
    versions, then 3 + 20 steps on a repeated batch: median step ms,
    host ms in the pull and the push, host syncs, B5/B6 launches (3 and 2
    a key a step, exactly), idle share, peak memory; every untouched row
    bit-equal to its initial value; B5 and B6 at the loop's shape against
    their plain versions, timed; (b) ``LibSVMIter`` at Avazu's width
    (1,000,000 features, batch 8192) over a seeded 65,536-row file,
    ``sparse.dot(csr, w)`` and ``dot(csr, g, transpose_a=True)`` card vs
    CPU, cast_storage, sparse_retain and ``.params`` round trips, peak
    memory far below one dense batch; (c) ``Module.fit`` of
    example/sparse/symbolic_sparse_lr.py's SparseEmbedding classifier
    (vocab 1,000,000, dim 16, 8 ids a row, batch 8192) through
    ``KVStore("device")`` with ``sparse_row_id_fn``, one step at vocab
    10,000 card vs CPU, the cross-entropy falling on a repeated batch;
37. data IO: ResNet-50 from JPEG records through ``ImageRecordIter`` and
    ``Module.fit``, Gluon through the ``DataLoader``'s worker processes,
    SSD through ``ImageDetIter`` (the feed against batches in memory);
38. data parallelism across processes, each gang started by
    ``tools/launch.py`` from here (``--dist-worker``): step 0 asks
    ``tools/torch_dist_probe.py`` which collectives two ranks on this
    machine's cards can run over NCCL and over gloo; (a) ``Module.fit``
    with ``kvstore="dist_sync"`` and 2-bit compression over two ranks,
    GPT-2-small at batch 8 a rank, 3 steps, on NCCL where two ranks may
    share the card, else on gloo: B1/B2a/B2b and one grouped B7 launch
    a push in each rank, both ranks' weights bit-equal to each other and
    to one process that sums the two ranks' compressed gradients; (b) the
    dp and ZeRO ``ShardedTrainer`` on the same LM at global batch 16 and
    (c) the recommender at the Criteo shape over a dp mesh need NCCL
    across two ranks: over two cards at dp 2 (ZeRO's momentum halved,
    its audited bytes equal to ``zero_update_model_bytes``; the
    recommender's shards against one process's step on the whole batch);
    where the card is alone they run the same code at dp 1 over a
    one-rank NCCL group and print why dp 2 was not run; (d) ResNet-50
    through a ``Module`` over ``[gpu(0), gpu(1)]`` (``gpu(0)`` twice on
    one card) at batch 32 split 16/16 with ``KVStore("device")`` against
    one context summing the two halves' gradients.
39. tensor parallelism: step 0 (38's probe) says whether gloo takes
    ``new_group`` subgroups on CUDA tensors (it must, where NCCL refuses
    two ranks of one card) and records ``batch_isend_irecv``; (a) the tp
    ``ShardedTrainer`` on GPT-2-small, tp 2 over two ranks (gloo on one
    card; dp2 x tp2 over NCCL on four cards), 3 steps: B1/B2a/B2b on
    every rank, the ranks' whole parameters bit-equal, the update within
    1e-3 of one process's on the same data; (b) tp-2 decode at full
    width in f32, int8 and int4 through the ``DecodeEngine`` on rank 0
    (rank 1 follows): tokens equal to one process's, f32 logits within
    1e-4, one step's collectives equal to ``decode_tp_model_bytes``, B3
    and B4 launched on each rank at its shapes, then B3 (H 6) and B4 at
    every per-rank block against their plain versions; (c)
    ``Module.fit`` over ``group2ctxs`` (example/model_parallel/
    two_stage.py's net) bit-equal to the unsegmented Module.

40. item 7's step 2, each over one mesh axis's process group (gloo gangs
    of 2, and 4 for (d), on one card; NCCL at n = 4 on four cards), step
    0 asking the probe whether the backend takes ``all_to_all_single``
    with split sizes over subgroups (the hop's form): (a) ring attention
    in example/long_context/ring_transformer.py's block at TRAIN's widths,
    B 1, T 16384 over sp, causal, f32 then bf16, forward and backward:
    B1 on the diagonal block (causal) and below it (no mask), B2a/B2b
    against the merged lse, every rank's out, dx and the parameters'
    gradients against one process's block over the whole sequence; the
    ring's kernels against their plain versions at T 2048 a block, timed
    at the rank's block; (b) TRAIN's 12 blocks as 2 stages through
    ``PipelineRunner.loss_and_grad``, 4 micro-batches of (2, 1024, 768),
    against the blocks in sequence; (c) Switch-Base-8's FFN over ep 2,
    8192 tokens, against ``moe_ffn_dense``, 5 SGD steps; (d) the
    two-tier all-reduce of the LM's gradients over island 2 x dp 2
    against the flat all-reduce, its trail against the model.

Launch counters are set to 0 just before each path is driven and read
just after it: every kernel of the path must have launched, exactly once
per layer per step (once per matmul for the quantized ones; two grouped
gathers per recommender step and two scatters per table, a bf16 table's
counted under its dtype; one grouped two-bit launch per ``Module.fit``
step and dtype while its keys fit in one launch's parameters).

Run from the root of a checkout:  ``python3 chip_smoke.py``.  It needs one
CUDA card, exits non-zero without one (or without the package beside it),
and prints as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The line before it holds the kernels' numbers as JSON, and the line before
that the card's name and power limit as nvidia-smi reports them.
"""
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_S = 3.35e12         # H100 SXM device memory rate
F32_FLOPS_S = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOPS_S = 495e12         # H100 SXM dense TF32 on the tensor cores

FULL = dict(vocab_size=32768, num_layers=12, hidden=768, heads=12,
            seq_len=1024, page_size=64, max_seqs=8)


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def log(*parts):
    print(*parts, flush=True)


class phase:
    """Prints a phase's elapsed seconds when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log("== phase %s" % self.name)

    def __exit__(self, *exc):
        log("== phase %s: %.1f s" % (self.name,
                                     time.perf_counter() - self.t0))
        return False


def spin_cycles(torch, fn):
    """Cycles of ``torch.cuda._sleep`` that outlast the host's enqueue of
    ``fn`` (a warm call, timed on the host clock) twice over at up to
    2 GHz, and at least 2,000,000 (~1 ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return max(2_000_000, min(int(host_s * 4e9), 400_000_000))


class Timer:
    """Median per-call device time (CUDA events), each call after a read
    of 64 MB (more than the 50 MB L2) that evicts its inputs, as the
    decode step finds its weights cold.  The flush only reads, so it
    leaves no dirty lines whose write-back would land inside the timed
    call.  A spin kernel between the flush and the start event keeps the
    card busy while the host enqueues the call (at least 1 ms, and twice
    the host's enqueue time of the call: a grouped wrapper prepares
    hundreds of segments first), so the events time the device work and
    not the host's launch overhead."""

    def __init__(self, torch, iters=25):
        self.torch = torch
        self.iters = iters
        self.flush = torch.ones(16 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn):
        torch = self.torch
        fn()
        spin = spin_cycles(torch, fn)
        ts = []
        for _ in range(self.iters):
            self.flush.sum()
            torch.cuda._sleep(spin)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)


def host_ms(torch, fn, n):
    """Host ms per call of ``fn``: ``n`` calls enqueued back to back (few
    enough that the launch queue never fills), on the host clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / F32_FLOPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_by_kernel(prof):
    """{kernel name: (device us, count)} of a torch.profiler run."""
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and ev.device_type.name == "CUDA":
            out[ev.key] = (dev_us, ev.count)
    return out


def phase_kernels(torch, kernels, F, timer, card):
    """Every kernel against its plain version at the decode step's
    shapes, with times and bounds."""
    c = FULL
    h, V, L = c["hidden"], c["vocab_size"], c["num_layers"]
    rows = decode_attention_rows(torch, kernels, F, timer, c["heads"], L)
    shapes = [("q/k/v/proj", h, h, 4 * L), ("ff1", 4 * h, h, L),
              ("ff2", h, 4 * h, L), ("head", V, h, 1)]
    rows += quant_matmul_rows(torch, kernels, timer, shapes)
    log_rows(rows, card)
    return rows


def decode_attention_rows(torch, kernels, F, timer, H, per_step, where=""):
    """B3 against its plain version and SDPA over FULL's pool at ``H``
    heads: the decode step's mix of lengths and the full cache."""
    rows = []
    dev = torch.device("cuda")
    c = FULL
    S, D, page = c["max_seqs"], c["hidden"] // c["heads"], c["page_size"]
    max_pages = c["seq_len"] // page
    P = 1 + S * max_pages
    rs = np.random.RandomState(0)
    q = torch.from_numpy(rs.randn(S, H, D).astype(np.float32)).to(dev)
    kp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    vp = torch.from_numpy(rs.randn(P, H, page, D).astype(np.float32)).to(dev)
    pt = torch.from_numpy(rs.permutation(np.arange(1, P)).reshape(
        S, max_pages).astype(np.int32)).to(dev)
    # the decode step's mix (inactive, one token, a page boundary,
    # mid-page lengths, the maximum) and the full cache, where the split
    # over the sequence has the most to do
    for tag, lens in (("step mix", [0, 1, 64, 100, 1024, 513, 300, 777]),
                      ("full cache", [c["seq_len"]] * S)):
        lens = np.array(lens, np.int32)
        sl = torch.from_numpy(lens).to(dev)
        out = kernels.decode_attention(q, kp, vp, pt, sl)
        ref = kernels.decode_attention_plain(q, kp, vp, pt, sl)
        torch.cuda.synchronize()
        act = sl > 0
        err = (out[act] - ref[act]).abs().max().item()
        # f32 both sides; online softmax over up to 1024 keys in another
        # summation order: 1e-5 absolute on outputs of magnitude ~1
        tol = 1e-5
        log("decode_attention S%d H%d D%d page%d P%d lens=%s: max_abs_err="
            "%.3g (tolerance %.0e: f32 both sides, online vs one-pass "
            "softmax)" % (S, H, D, page, P, lens.tolist(), err, tol))
        check(err <= tol and torch.isfinite(out).all().item()
              and bool((out[~act] == 0).all()),
              "decode_attention disagrees with its plain version")
        check(torch.equal(out, kernels.decode_attention(q, kp, vp, pt, sl)),
              "two launches of decode_attention gave different bits")
        tot = int(lens.sum())
        nbytes = 2 * tot * H * D * 4 + 2 * S * H * D * 4 + pt.numel() * 4 \
            + S * 4
        b, by = bound_ms(nbytes, 4.0 * tot * H * D)
        # yardstick: one SDPA call over contiguous K/V of the same
        # lengths, padded to the longest and masked (its mask keeps
        # inactive rows finite by letting them see key 0)
        T = int(lens.max())
        kc = torch.zeros(S, H, T, D, device=dev)
        vc = torch.zeros(S, H, T, D, device=dev)
        for s in range(S):
            n = int(lens[s])
            if n:
                ks = kp[pt[s].long()].permute(1, 0, 2, 3).reshape(H, -1, D)
                vs = vp[pt[s].long()].permute(1, 0, 2, 3).reshape(H, -1, D)
                kc[s, :, :n], vc[s, :, :n] = ks[:, :n], vs[:, :n]
        mask = torch.arange(T, device=dev)[None, :] < \
            torch.from_numpy(np.maximum(lens, 1)).to(dev)[:, None]
        mask = mask[:, None, None, :]
        lib = F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                             attn_mask=mask)[:, :, 0]
        check((lib[act] - ref[act]).abs().max().item() < 1e-4,
              "the SDPA yardstick computes another function")
        row = {
            "name": "decode_attention", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/decode_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:619",
            "shape": "%sS%d H%d D%d page%d, %s, sum(seq_lens)=%d"
                     % (where, S, H, D, page, tag, tot),
            "launches_per_step": per_step,
            "max_abs_err": err,
            "ms": timer(lambda: kernels.decode_attention(q, kp, vp, pt, sl)),
            "plain_ms": timer(lambda: kernels.decode_attention_plain(
                q, kp, vp, pt, sl)),
            "bound_ms": b, "bound_by": by,
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask)),
            "library_call": "F.scaled_dot_product_attention over contiguous "
                            "K/V padded to %d, masked" % T,
        }
        del kc, vc
        rows.append(row)
    del kp, vp
    return rows


def quant_matmul_rows(torch, kernels, timer, shapes, where=""):
    """B4 (int8 and int4) against its plain version at the decode step's
    M = S rows and each ``(label, N, K, launches a step)`` of ``shapes``."""
    rows = []
    dev = torch.device("cuda")
    M = FULL["max_seqs"]
    rs = np.random.RandomState(0)
    for bits in (8, 4):
        for label, N, K, per_step in shapes:
            w = (rs.randn(N, K) * 0.02).astype(np.float32)
            qw_np, sc_np = kernels.quantize_weight(w, bits)
            x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).to(dev)
            qw = torch.from_numpy(qw_np).to(dev)
            sc = torch.from_numpy(sc_np).to(dev)
            wf = (kernels.unpack_int4(qw)[:, :K] if bits == 4
                  else qw.float()) * sc[:, None]
            out = kernels.quant_matmul(x, qw, sc, bits)
            again = kernels.quant_matmul(x, qw, sc, bits)
            ref = kernels.quant_matmul_plain(x, qw, sc, bits)
            torch.cuda.synchronize()
            check(torch.equal(out, again), "two launches of quant_matmul "
                  "int%d %s gave different bits" % (bits, label))
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            # scale applied after vs before an f32 sum over K terms, in
            # another order: 1e-5 relative to the result's magnitude
            tol = 1e-5 * max(scale, 1.0)
            log("quant_matmul int%d %s%s (%dx%d)@(%dx%d)^T: max_abs_err=%.3g"
                " (tolerance %.3g = 1e-5 x max|y|)"
                % (bits, where, label, M, K, N, K, err, tol))
            check(err <= tol, "quant_matmul int%d %s%s disagrees with its "
                  "plain version" % (bits, where, label))
            nbytes = qw.numel() + 4 * N + 4 * M * K + 4 * M * N
            b, by = bound_ms(nbytes, 2.0 * M * N * K)
            # the same work on the tensor cores: two TF32 MMAs per product
            # (x split in two; the integer weights are exact in TF32)
            tc = max(nbytes / HBM_BYTES_S,
                     2 * 2.0 * M * N * K / TF32_FLOPS_S) * 1e3
            rows.append({
                "name": "quant_matmul_int%d" % bits, "route": "cuda",
                "source": "mxnet_tpu_torch/csrc/quant_matmul.cu",
                "replaces": "mxnet_tpu/ops/pallas_kernels.py:743",
                "shape": "%s%s: x (%d,%d) w (%d,%d)" % (where, label, M, K,
                                                         N, K),
                "launches_per_step": per_step,
                "max_abs_err": err,
                "ms": timer(lambda: kernels.quant_matmul(x, qw, sc, bits)),
                "plain_ms": timer(lambda: kernels.quant_matmul_plain(
                    x, qw, sc, bits)),
                "bound_ms": b, "bound_by": by, "bound_tc_ms": tc,
                "math": "2xtf32 mma.sync (x split; integer w exact)",
                "library_ms": timer(lambda: torch.matmul(x, wf.T)),
                "library_call": "torch.matmul(x, w_f32.T)",
            })
    return rows


def log_rows(rows, card):
    for r in rows:
        log("  %-18s %-34s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "bound_tc_ms=%s library_ms=%s  [%s]"
            % (r["name"], r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
               r["bound_by"], "%.4f" % r["bound_tc_ms"]
               if "bound_tc_ms" in r else "-",
               "%.4f" % r["library_ms"], card))


def teacher_forced(progs, steps, n_active, seed):
    """Run the same teacher-forced steps through each program; returns
    per program the list of (next_tokens, logits) of the active slots
    and the final pools."""
    c = progs[0].config
    S, pp = c.max_seqs, c.pages_per_seq
    table = np.zeros((S, pp), np.int32)
    for s in range(n_active):
        table[s] = 1 + s * pp + np.arange(pp)
    act = (np.arange(S) < n_active).astype(np.int32)
    toks = np.random.RandomState(seed).randint(
        0, c.vocab_size, (S, steps)).astype(np.int32)
    kvs = [p.fresh_cache() for p in progs]
    outs = [[] for _ in progs]
    for t in range(steps):
        pos = np.full(S, t, np.int32) * act
        args = (toks[:, t], pos, (pos + 1) * act,
                table[np.arange(S), pos // c.page_size] * act,
                (pos % c.page_size) * act, table)
        for i, p in enumerate(progs):
            nxt, logits, kvs[i] = p.step(kvs[i], *args)
            outs[i].append((nxt[:n_active].cpu(), logits[:n_active].cpu()))
    return outs, kvs


def phase_step_parity(torch, DecodeConfig, DecodeProgram, init_params):
    """The decode step on the card against the same step on the CPU
    (plain versions), small and at full width."""
    cases = [(DecodeConfig(64, 2, 32, 4, 16, page_size=4, max_seqs=3),
              16, 2, (None, "int8", "int4")),
             (DecodeConfig(FULL["vocab_size"], FULL["num_layers"],
                           FULL["hidden"], FULL["heads"], FULL["seq_len"],
                           page_size=FULL["page_size"],
                           max_seqs=FULL["max_seqs"]),
              6, 7, (None, "int4"))]
    for cfg, steps, n_active, quants in cases:
        params = init_params(cfg, seed=1)
        for qz in quants:
            progs = [DecodeProgram(params, cfg, quantize=qz, device=d)
                     for d in ("cpu", "cuda")]
            outs, kvs = teacher_forced(progs, steps, n_active, seed=2)
            lerr = max((a[1] - b[1]).abs().max().item()
                       for a, b in zip(*outs))
            same = all(torch.equal(a[0], b[0]) for a, b in zip(*outs))
            kerr = (kvs[1][:, :, 1:].cpu() - kvs[0][:, :, 1:]).abs().max() \
                .item()
            log("step parity card vs cpu %s %s: %d steps, %d active slots: "
                "logits max_abs_err=%.3g (tolerance 1e-4), next tokens "
                "equal=%s, KV pages 1.. max_abs_err=%.3g (tolerance 1e-5)"
                % (cfg.describe(), qz or "f32", steps, n_active, lerr, same,
                   kerr))
            check(lerr < 1e-4 and same and kerr < 1e-5,
                  "decode step on the card disagrees with the CPU")
            del progs, kvs


def serve(torch, kernels, DecodeEngine, prog, requests, vip=None,
          parity=0, card=""):
    """Serve ``requests`` ([(prompt, max_new)]) through a DecodeEngine
    over ``prog``.  With ``vip`` = (prompt, max_new): submit one batch's
    worth of requests, wait until every slot is busy and the queue is
    empty, submit ``vip`` at a higher priority (it must evict exactly one
    running sequence), then submit the rest.  Returns a summary dict."""
    out = {}
    S = prog.config.max_seqs
    with DecodeEngine(prog, default_deadline=900.0, queue_depth=64) as eng:
        t0 = time.perf_counter()
        first = requests if vip is None else requests[:S]
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in first]
        vreq = None
        if vip is not None:
            t_wait = time.monotonic() + 120
            while (eng.stats()["decode"]["active_slots"] < S
                   and time.monotonic() < t_wait):
                time.sleep(0.001)
            st = eng.stats()
            check(st["decode"]["active_slots"] == S
                  and st["queue_depth"] == 0, "the batch never filled")
            vreq = eng.submit(vip[0], max_new_tokens=vip[1], priority=5)
            reqs += [eng.submit(p, max_new_tokens=n)
                     for p, n in requests[S:]]
        results, evicted = [], 0
        from mxnet_tpu_torch.serving.errors import Overloaded
        for r, (_p, n) in zip(reqs, requests):
            try:
                ids = r.result(timeout=900)[0]
                check(ids.size == n and ((0 <= ids) & (ids < prog.config
                                                       .vocab_size)).all(),
                      "a request came back with wrong tokens")
                results.append(ids)
            except Overloaded:
                evicted += 1
                results.append(None)
        wall = time.perf_counter() - t0
        if vreq is not None:
            ids = vreq.result(timeout=900)[0]
            check(ids.size == vip[1], "the priority arrival did not finish")
            check(evicted == 1, "expected exactly one eviction by the "
                  "priority arrival, saw %d" % evicted)
        st = eng.stats()
        out.update(wall_s=wall, evicted=evicted, stats=st["decode"],
                   latency=st.get("latency_s"))
        # continuous vs serial: the same engine, one request at a time
        done = [i for i, r in enumerate(results) if r is not None]
        for i in done[:parity]:
            p, n = requests[i]
            again = eng.generate(p, max_new_tokens=n)
            check(np.array_equal(again, results[i]),
                  "continuous batching changed the tokens of request %d" % i)
        out["parity_checked"] = min(parity, len(done))
        out["step_calls"] = eng.stats()["counters"]["steps"]
    d = out["stats"]
    toks = d["tokens_decoded"] + d["tokens_prefilled"]
    log("serve %s: %d requests (+%d priority), %d evicted, %d steps, "
        "%d tokens fed (%d decoded) in %.3f s = %.1f tok/s; step p50 "
        "%.3f ms p99 %.3f ms; occupancy %.3f; serial parity checked on %d "
        "[%s]" % (prog.config.describe(), len(requests),
                  0 if vip is None else 1, out["evicted"],
                  out["step_calls"], toks, d["tokens_decoded"],
                  out["wall_s"], toks / out["wall_s"],
                  d["token_step_s"]["p50"] * 1e3,
                  d["token_step_s"]["p99"] * 1e3, d["occupancy_mean"],
                  out["parity_checked"], card))
    return out


def steady_args(prog, cached_per_slot):
    """Step inputs with every slot active at the same cached length (the
    slot's last token at position ``cached_per_slot - 1``)."""
    c = prog.config
    S, pp = c.max_seqs, c.pages_per_seq
    table = (1 + np.arange(S)[:, None] * pp + np.arange(pp)).astype(np.int32)
    pos = np.full(S, cached_per_slot - 1, np.int32)
    return (np.zeros(S, np.int32), pos, pos + 1,
            table[np.arange(S), pos // c.page_size], pos % c.page_size,
            table)


def step_timing(torch, prog, cached_per_slot, steps=30):
    """Steady state of the full batch: median host ms of a step that
    waits for its next tokens (as the engine does), and ms per step with
    steps queued back to back (CUDA events around the run)."""
    args = steady_args(prog, cached_per_slot)
    kv = prog.fresh_cache()
    for _ in range(3):
        nxt, _l, kv = prog.step(kv, *args)
    torch.cuda.synchronize()
    host = []
    for _ in range(steps):
        t0 = time.perf_counter()
        nxt, _l, kv = prog.step(kv, *args)
        nxt.cpu()
        host.append((time.perf_counter() - t0) * 1e3)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(steps):
        nxt, _l, kv = prog.step(kv, *args)
    e.record()
    e.synchronize()
    return statistics.median(host), s.elapsed_time(e) / steps


def profile_step(torch, prog, cached_per_slot):
    """Device time per kernel name over a few steady steps
    (torch.profiler): ``[(us per step, launches per step, name)]``."""
    from torch.profiler import ProfilerActivity, profile
    args = steady_args(prog, cached_per_slot)
    kv = prog.fresh_cache()
    prog.step(kv, *args)
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            nxt, _l, kv = prog.step(kv, *args)
        nxt.cpu()
    rows = [(us / n, cnt // n, key)
            for key, (us, cnt) in device_by_kernel(prof).items()]
    rows.sort(reverse=True)
    return rows


def host_costs(torch, kernels, card, n=400):
    """Host time per call of each wrapper and of the pieces it is made
    of, at the smallest decode shape (the card keeps up, so the host's
    enqueue rate is what is measured)."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(1)
    K = N = FULL["hidden"]
    x = torch.from_numpy(rs.randn(8, K).astype(np.float32)).to(dev)
    w = torch.from_numpy(rs.randn(N, K).astype(np.float32)).to(dev)
    qw_np, sc_np = kernels.quantize_weight(rs.randn(N, K), 8)
    qw, sc = torch.from_numpy(qw_np).to(dev), torch.from_numpy(sc_np).to(dev)
    b = torch.zeros(N, device=dev)

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    def ctx():
        with torch.cuda.device(dev):
            pass

    costs = [
        ("quant_matmul int8 wrapper", lambda: kernels.quant_matmul(
            x, qw, sc, 8)),
        ("x @ W.T + b (f32 path)", lambda: x @ w.T + b),
        ("torch.empty((8, 768))", lambda: torch.empty((8, N), device=dev)),
        ("torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("kernels._stream_ptr (raw stream)", lambda: kernels._stream_ptr(0)),
        ("with torch.cuda.device(dev)", ctx),
        ("3x data_ptr()", lambda: (x.data_ptr(), qw.data_ptr(),
                                   sc.data_ptr())),
    ]
    for name, fn in costs:
        log("host cost %-44s %7.2f us/call [%s]" % (name, per_call(fn), card))


def report_profile(torch, prog, tag, cached, card):
    """Print the per-kernel device time of a steady step; returns the
    device-busy ms per step, or None where the profiler saw no device
    time (a measurement aid: it never fails the run)."""
    try:
        rows = profile_step(torch, prog, cached)
    except Exception as e:
        log("profile %s: not measured (%r)" % (tag, e))
        return None
    if not rows:
        log("profile %s: not measured (no device events)" % tag)
        return None
    log("device time per %s step by kernel (torch.profiler, all slots at "
        "%d cached tokens) [%s]:" % (tag, cached, card))
    for us, cnt, key in rows[:10]:
        log("  %9.1f us  x%-4d %s" % (us, cnt, key[:90]))
    total = sum(r[0] for r in rows)
    log("  %9.1f us  total device time per step" % total)
    return total / 1e3


TRAIN = dict(vocab_size=32768, seq_len=1024, num_layers=12, hidden=768,
             heads=12)


def flash_bound(B, Tq, Tk, H, D, causal, units, n_in, n_out, n_rows):
    """Bound of one flash kernel: ``units`` x 2·D flops per (q, k) pair
    that the mask keeps (4 for the forward, 6 for dQ, 8 for dK/dV, as
    4·BH·T²·D·½ etc.), and ``n_in`` (B, T, H, D) tensors read, ``n_out``
    written, plus ``n_rows`` (B·H, T) f32 rows (the forward writes lse;
    the backward kernels read lse and delta)."""
    if causal:
        pairs = sum(min(Tk, q + 1) for q in range(Tq))
    else:
        pairs = Tq * Tk
    flops = units * B * H * pairs * D
    nbytes = (n_in + n_out) * B * Tq * H * D * 4 + n_rows * B * H * Tq * 4
    b, by = bound_ms(nbytes, flops)
    # the same work in 3xTF32: three TF32 MMAs per f32 product
    tc = max(nbytes / HBM_BYTES_S, 3 * flops / TF32_FLOPS_S) * 1e3
    return b, by, tc


# kernels that run TF32 MMAs on the tensor cores, by library (the f32
# flash forward, dQ and dK/dV, and the quantized matmul), and the 16-bit
# flash forward, dQ and dK/dV (B9), whose bf16 instantiations run bf16
# MMAs and no TF32 one and whose f16 instantiations f16 MMAs and no TF32
# or bf16 one
TF32_KERNELS = {"flash_attention": ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                    "flash_bwd_dkv_kernel"),
                "quant_matmul": ("quant_matmul_kernel",)}
BF16_KERNELS = {"flash_attention": ("flash_fwd16_kernel",
                                    "flash_bwd_dq16_kernel",
                                    "flash_bwd_dkv16_kernel")}
# the element type in a 16-bit kernel's mangled name -> its MMA in SASS
LOWP_TYPES = (("__nv_bfloat16", "bf16"), ("__half", "f16"))


def sass_check(build, card):
    """The 3xTF32 kernels (the f32 flash kernels and quant_matmul's two
    instantiations with x split in two) run TF32 MMAs on the tensor
    cores, and the 16-bit flash kernels run m16n8k16 MMAs of their
    element type and no TF32 one: the SASS of each instantiation
    (``cuobjdump -sass`` of the built library) holds ``HMMA...TF32``,
    respectively ``HMMA.16816.F32.BF16`` (bf16) or ``HMMA.16816.F32``
    (f16) and no other HMMA."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.isfile(tool), "cuobjdump not found (PATH, "
          "/usr/local/cuda/bin): the SASS check cannot run")
    paths = build.build_kernels(list(TF32_KERNELS))
    for lib, names in TF32_KERNELS.items():
        res = subprocess.run([tool, "-sass", paths[lib]], capture_output=True,
                             text=True, timeout=300)
        check(res.returncode == 0, "cuobjdump -sass failed: %s" % res.stderr)
        # function -> [TF32 HMMA, bf16 HMMA.16816, f16 HMMA.16816]
        counts, fn = {}, None
        for line in res.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = [0, 0, 0]
            elif fn and "HMMA" in line:
                counts[fn][0] += "TF32" in line
                counts[fn][1] += "HMMA.16816.F32.BF16" in line
                counts[fn][2] += bool(re.search(r"HMMA\.16816\.F32 ",
                                                line + " "))
        for name in names:
            got = {f: n[0] for f, n in counts.items() if name in f}
            check(got and all(n > 0 for n in got.values()),
                  "%s: no TF32 HMMA in its SASS (%s)" % (name, got))
            log("SASS %s: TF32 HMMA instructions per instantiation %s [%s]"
                % (name, sorted(got.values()), card))
        for name in BF16_KERNELS.get(lib, ()):
            for i, (ctype, kind) in enumerate(LOWP_TYPES):
                got = {f: n for f, n in counts.items()
                       if name in f and ctype in f}
                check(len(got) == 3 and all(
                    n[1 + i] > 0 and n[0] == 0 and n[2 - i] == 0
                    for n in got.values()),
                    "%s<%s>: not %s HMMA.16816 alone in its SASS (TF32, "
                    "bf16, f16 per instantiation: %s)"
                    % (name, kind, kind, list(got.values())))
                log("SASS %s<%s>: HMMA.16816 %s instructions per "
                    "instantiation %s, TF32 none [%s]"
                    % (name, kind, kind, sorted(n[1 + i] for n in
                                                got.values()), card))


def flash_tf32_cases(torch, kernels, card):
    """Two launches of each flash kernel are bit-equal; and the
    tolerances tell 3xTF32 from 1xTF32: on inputs whose logits reach
    ~+-20 the plain versions' einsums under ``allow_tf32`` exceed them,
    the kernels stay inside them (as tests/test_torch_kernels_cuda.py):
    out and lse 1e-5, dq/dk/dv 1e-4, each x max(1, max|ref|)."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(21)
    q, k, v, do = (torch.from_numpy(rs.randn(2, 256, 2, 64).astype(
        np.float32)).to(dev) for _ in range(4))
    q, k = q * 2.5, k * 2.5
    out, lse = kernels.flash_attention_fwd_plain(q, k, v, True)
    delta = kernels.flash_delta(out, do)
    runs = [kernels.flash_attention_fwd(q, k, v, True)
            + (kernels.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                              True),)
            + kernels.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
            for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "two launches of the flash kernels gave different bits")
    refs = (out, lse) + kernels.flash_attention_bwd_plain(
        q, k, v, out, lse, do, True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = kernels.flash_attention_fwd_plain(q, k, v, True) + \
            kernels.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ratios = []
    for name, base, got, t, ref in zip(
            ("out", "lse", "dq", "dk", "dv"), (1e-5, 1e-5, 1e-4, 1e-4, 1e-4),
            runs[0], tf32, refs):
        tol = base * max(1.0, ref.abs().max().item())
        ratios.append((name, (got - ref).abs().max().item() / tol,
                       (t - ref).abs().max().item() / tol))
    log("flash kernels, logits to ~+-20: error / tolerance, kernel vs "
        "1xTF32 einsums: %s; two launches bit-equal [%s]"
        % (", ".join("%s %.3g vs %.3g" % r for r in ratios), card))
    check(all(r[1] <= 1.0 for r in ratios),
          "the 3xTF32 kernels exceed the tolerance on large logits")
    check(max(r[2] for r in ratios[:2]) > 1.0
          and max(r[2] for r in ratios[2:]) > 1.0,
          "1xTF32 stays within the tolerance: it cannot tell them apart")


def phase_flash(torch, kernels, F, timer, card):
    """The three flash kernels against their plain versions at the
    training shape (timed), and at a ragged and a non-causal shape."""
    dev = torch.device("cuda")
    H, D = TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"]
    rows = []
    cases = [(8, 1024, True, True), (8, 1000, True, False),
             (4, 1024, False, False)]
    for B, T, causal, timed in cases:
        rs = np.random.RandomState(T + B)
        q, k, v, do = (torch.from_numpy(rs.randn(B, T, H, D).astype(
            np.float32)).to(dev) for _ in range(4))
        tag = "B%d T%d H%d D%d %s" % (B, T, H, D,
                                      "causal" if causal else "full")
        out, lse = kernels.flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = kernels.flash_attention_fwd_plain(q, k, v, causal)
        delta = kernels.flash_delta(ref, do)
        dq = kernels.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta,
                                            causal)
        dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, ref_lse,
                                                 delta, causal)
        refs = kernels.flash_attention_bwd_plain(q, k, v, ref, ref_lse, do,
                                                 causal)
        torch.cuda.synchronize()
        errs = {"out": (out - ref).abs().max().item(),
                "lse": (lse - ref_lse).abs().max().item()}
        tols = {"out": 1e-5, "lse": 1e-5}
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            errs[name] = (got - want).abs().max().item()
            tols[name] = 1e-4 * max(1.0, want.abs().max().item())
        log("flash %s: max_abs_err %s (tolerances: out, lse 1e-5 absolute, "
            "f32 both sides, online vs one-pass softmax; dq/dk/dv 1e-4 x "
            "max(1, max|ref|): sums over up to %d rows in another order)"
            % (tag, ", ".join("%s=%.3g/%.3g" % (n, errs[n], tols[n])
                              for n in errs), T))
        check(all(errs[n] <= tols[n] for n in errs),
              "flash kernels disagree with their plain versions at %s" % tag)
        if not timed:
            continue
        # yardstick: SDPA in f32 on the (B, H, T, D) transposes, forward
        # and its autograd backward (dQ, dK, dV together); timed only
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
        check((lib_out.transpose(1, 2) - ref).abs().max().item() < 1e-4,
              "the SDPA yardstick computes another function")
        lib_fwd = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        lib_bwd = timer(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True))
        del lib_out
        src = "mxnet_tpu_torch/csrc/flash_attention.cu"
        b_f, by_f, tc_f = flash_bound(B, T, T, H, D, causal, 4, 3, 1, 1)
        b_q, by_q, tc_q = flash_bound(B, T, T, H, D, causal, 6, 4, 1, 2)
        b_kv, by_kv, tc_kv = flash_bound(B, T, T, H, D, causal, 8, 4, 2, 2)
        shape = "q/k/v (B, T, H, D) = (%d, %d, %d, %d) f32, causal" % (
            B, T, H, D)
        per_step = TRAIN["num_layers"]
        rows += [{
            "name": "flash_attention_fwd", "route": "cuda", "source": src,
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:250",
            "shape": shape + ", with lse", "launches_per_step": per_step,
            "max_abs_err": max(errs["out"], errs["lse"]),
            "ms": timer(lambda: kernels.flash_attention_fwd(q, k, v,
                                                            causal)),
            "plain_ms": timer(lambda: kernels.flash_attention_fwd_plain(
                q, k, v, causal)),
            "bound_ms": b_f, "bound_by": by_f, "bound_tc_ms": tc_f,
            "math": "3xtf32 mma.sync", "library_ms": lib_fwd,
            "library_call": "F.scaled_dot_product_attention(is_causal="
                            "True) f32 forward",
        }, {
            "name": "flash_attention_bwd_dq", "route": "cuda", "source": src,
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:448",
            "shape": shape + ", dO, lse, delta",
            "launches_per_step": per_step, "max_abs_err": errs["dq"],
            "ms": timer(lambda: kernels.flash_attention_bwd_dq(
                q, k, v, do, ref_lse, delta, causal)),
            "plain_ms": timer(lambda: kernels.flash_attention_bwd_dq_plain(
                q, k, v, do, ref_lse, delta, causal)),
            "bound_ms": b_q, "bound_by": by_q, "bound_tc_ms": tc_q,
            "math": "3xtf32 mma.sync", "library_ms": lib_bwd,
            "library_call": "autograd backward of the SDPA forward (dQ, "
                            "dK and dV together)",
        }, {
            "name": "flash_attention_bwd_dkv", "route": "cuda",
            "source": src,
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:468",
            "shape": shape + ", dO, lse, delta",
            "launches_per_step": per_step,
            "max_abs_err": max(errs["dk"], errs["dv"]),
            "ms": timer(lambda: kernels.flash_attention_bwd_dkv(
                q, k, v, do, ref_lse, delta, causal)),
            "plain_ms": timer(lambda: kernels.flash_attention_bwd_dkv_plain(
                q, k, v, do, ref_lse, delta, causal)),
            "bound_ms": b_kv, "bound_by": by_kv, "bound_tc_ms": tc_kv,
            "math": "3xtf32 mma.sync", "library_ms": lib_bwd,
            "library_call": "autograd backward of the SDPA forward (dQ, "
                            "dK and dV together)",
        }]
        del qt, kt, vt
    for r in rows:
        log("  %-24s %-48s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "bound_tc_ms=%.4f library_ms=%.4f  [%s; %s]"
            % (r["name"], r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
               r["bound_by"], r["bound_tc_ms"], r["library_ms"], r["math"],
               card))
    return rows


def lm_batch(vocab, batch, seq, seed):
    rs = np.random.RandomState(seed)
    return {"data": rs.randint(0, vocab, (batch, seq)).astype(np.float32),
            "softmax_label": rs.randint(0, vocab, (batch, seq))
            .astype(np.float32)}


def cross_entropy(torch, trainer, params, aux, batch):
    """mean -log p[label] from a forward's SoftmaxOutput probabilities
    (no gradient)."""
    prog = trainer.prog
    args = [None] * len(prog.arg_names)
    for i, p in zip(trainer.param_idx, params):
        args[i] = p
    for n in trainer.input_names:
        args[trainer.input_idx[n]] = torch.as_tensor(batch[n],
                                                     device=trainer.device)
    with torch.no_grad():
        probs = prog.evaluate(args, aux, train=False)[0][0]
        lab = args[trainer.input_idx["softmax_label"]].reshape(-1).long()
        picked = probs.gather(1, lab[:, None]).double()
        return float(-picked.log().mean())


def phase_train_parity(torch, get_symbol, ShardedTrainer, card):
    """One training step on the card and on the CPU (plain versions)
    from the same state, at full width and depth 2, batch 2."""
    cfg = dict(TRAIN, num_layers=2)
    net = get_symbol(**cfg)
    shapes = {"data": (2, cfg["seq_len"]), "softmax_label":
              (2, cfg["seq_len"])}
    batch = lm_batch(cfg["vocab_size"], 2, cfg["seq_len"], seed=7)
    result = {}
    for dev in ("cuda", "cpu"):
        tr = ShardedTrainer(net, lr=0.01, momentum=0.9, wd=1e-4,
                            device=dev)
        if dev == "cuda":
            params, mom, aux = tr.init_state(shapes, seed=3)
            start = [p.detach().to("cpu", copy=True) for p in params]
        else:
            params = tuple(p.clone() for p in start)
            mom = tuple(torch.zeros_like(p) for p in params)
            aux = ()
        t0 = time.perf_counter()
        params, mom, aux, loss = tr.step(params, mom, aux, batch)
        loss = float(loss)
        dt = time.perf_counter() - t0
        ce = cross_entropy(torch, tr, params, aux, batch)
        result[dev] = ([p.detach().cpu() - s for p, s in zip(params, start)],
                       ce, loss, dt)
        log("train step %s L%d h%d T%d batch 2: %.2f s, loss %.1f, "
            "cross-entropy after %.6f" % (dev, cfg["num_layers"],
                                         cfg["hidden"], cfg["seq_len"], dt,
                                         loss, ce))
    worst = 0.0
    cpu_update = dict(zip(tr.param_names, result["cpu"][0]))
    for name, a, b in zip(tr.param_names, result["cuda"][0],
                          result["cpu"][0]):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if name.endswith("_k_bias"):
            # the softmax is invariant to a per-row shift of the scores,
            # so the key bias gets no gradient: both updates are rounding
            # noise of a zero, whose size depends on the CPU's summation
            # order.  Each must stay within the same 1e-3 of the update of
            # the layer's key weight, the sum of the same dK rows weighted
            # by the layer's input.
            ref = cpu_update[name[:-len("bias")] + "weight"]
            limit = 1e-3 * ref.abs().max().item()
            moved = max(scale, a.abs().max().item())
            check(moved <= limit,
                  "%s moved by %.3g on the card and %.3g on the CPU; its "
                  "gradient is zero, and the limit is %.3g (1e-3 of the "
                  "key weight's largest update)"
                  % (name, a.abs().max().item(), scale, limit))
            log("%s (no gradient): moved by %.3g on the card and %.3g on "
                "the CPU, limit %.3g" % (name, a.abs().max().item(), scale,
                                         limit))
            continue
        worst = max(worst, err / scale)
        check(err <= 1e-3 * scale,
              "update of %s on the card differs from the CPU: max_abs_err "
              "%.3g vs its largest update %.3g" % (name, err, scale))
    ce_c, ce_h = result["cuda"][1], result["cpu"][1]
    log("train step card vs cpu: updates agree per tensor within %.3g of "
        "that tensor's largest update (tolerance 1e-3: f32 both sides, "
        "cuBLAS and the flash kernels vs CPU BLAS and the plain versions; "
        "the key biases, whose gradient is zero, within 1e-3 of the key "
        "weight's largest update); "
        "cross-entropy %.6f vs %.6f (tolerance 1e-4 relative) [%s]"
        % (worst, ce_c, ce_h, card))
    check(abs(ce_c - ce_h) <= 1e-4 * abs(ce_h),
          "cross-entropy on the card differs from the CPU")


def phase_train(torch, kernels, get_symbol, ShardedTrainer, flops_fn,
                card):
    """Full-width training: warm-up, five timed steps, a profiled step;
    returns (launch counts over the path's steps, summary)."""
    cfg = TRAIN
    B, T, L = 8, cfg["seq_len"], cfg["num_layers"]
    net = get_symbol(**cfg)
    tr = ShardedTrainer(net, lr=1e-4, momentum=0.9, wd=0.0)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    t0 = time.perf_counter()
    params, mom, aux = tr.init_state(shapes, seed=0)
    log("init_state(L%d h%d V%d, seed=0): %d tensors, %.1f M parameters, "
        "%.1f s" % (L, cfg["hidden"], cfg["vocab_size"], len(params),
                    sum(p.numel() for p in params) / 1e6,
                    time.perf_counter() - t0))
    batch = lm_batch(cfg["vocab_size"], B, T, seed=0)
    ce0 = cross_entropy(torch, tr, params, aux, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for i in range(6):              # 1 warm-up + 5 timed
        t0 = time.perf_counter()
        params, mom, aux, loss = tr.step(params, mom, aux, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, mom, aux, loss = tr.step(params, mom, aux, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    steps = 7
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ce1 = cross_entropy(torch, tr, params, aux, batch)
    log("launches on the training path: %s over %d steps" % (got, steps))
    for key in ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv"):
        check(got[key] == L * steps, "%s launched %d times over %d steps, "
              "want %d" % (key, got[key], steps, L * steps))
    by_kernel = device_by_kernel(prof)
    busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
    timed = times[1:]
    med = statistics.median(timed)
    flops = flops_fn(B, T, L, cfg["hidden"], cfg["vocab_size"])
    log("train step L%d h%d V%d T%d batch %d f32: warm-up %.1f ms; timed "
        "%s ms; median %.1f ms (spread %.1f-%.1f) = %.0f tokens/s [%s]"
        % (L, cfg["hidden"], cfg["vocab_size"], T, B, times[0],
           ", ".join("%.1f" % t for t in timed), med, min(timed),
           max(timed), B * T / med * 1e3, card))
    if by_kernel:
        log("device time of one step by kernel (torch.profiler) [%s]:"
            % card)
        for key, (us, cnt) in sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:12]:
            log("  %9.1f us  x%-4d %s" % (us, cnt, key[:90]))
        groups = {"flash kernels": 0.0, "matmuls (cuBLAS/CUTLASS f32)": 0.0,
                  "everything else": 0.0}
        for key, (us, _cnt) in by_kernel.items():
            group = ("flash kernels" if "flash_" in key else
                     "matmuls (cuBLAS/CUTLASS f32)" if "gemm" in key
                     else "everything else")
            groups[group] += us / 1e3
        log("  by group: %s" % ", ".join("%s %.1f ms" % kv
                                         for kv in groups.items()))
        # the profiled step's own wall time: the profiler slows the host,
        # so the unprofiled median is no denominator for its busy time
        log("  device busy %.1f ms of the profiled step's %.1f ms: idle "
            "share %.3f" % (busy_ms, prof_ms, 1 - busy_ms / prof_ms))
    else:
        log("device busy: not measured (the profiler saw no device time)")
    log("peak memory allocated %.2f GB; transformer_flops_per_step %.3f "
        "TFLOP -> %.1f TFLOP/s = %.3f of the 67 TFLOP/s f32 peak (%.1f ms "
        "at peak); cross-entropy before %.4f, after %d steps %.4f [%s]"
        % (peak / 1e9, flops / 1e12, flops / med / 1e9,
           flops / (med / 1e3) / F32_FLOPS_S, flops / F32_FLOPS_S * 1e3,
           ce0, steps, ce1, card))
    check(np.isfinite(ce0) and np.isfinite(ce1) and ce1 < ce0,
          "training did not lower the cross-entropy on the repeated batch "
          "(%.4f -> %.4f)" % (ce0, ce1))
    check(tr.skipped_steps == 0, "a training step was skipped as "
          "non-finite")
    return got, med


# the bench's recommender geometry (bench.py:215-219) and a Criteo-shaped
# one: 26 categorical features of 1M rows at dim 64, batch 8192
REC = dict(tables=4, rows=100000, dim=16, dense=13, hidden=(64, 32),
           batch=4096, lr=0.05, momentum=0.9)
CRITEO = dict(REC, tables=26, rows=1000000, dim=64, batch=8192)


def path_ids(rs, rows, n):
    """The ids the recommender path hands the kernels for a batch of ``n``
    random ids: the update's scatter ids (sorted unique ids, then pads
    equal to ``rows`` up to ``n``) and the gathers' (the same, clamped)."""
    u = np.unique(rs.randint(0, rows, n))
    sc = np.concatenate([u, np.full(n - len(u), rows)]).astype(np.int32)
    return len(u), sc, np.minimum(sc, rows - 1).astype(np.int32)


def embed_case(torch, sk, rows, D, n, seed, dev):
    """Check B5 and B6 (add and set) against their plain versions on one
    shape, exactly (a table of multiples of 2^-6 and payloads of
    multiples of 2^-10 make every sum exact in any order).  Returns the
    tensors the timing needs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randint(-64, 64, (rows, D), generator=g, device=dev) \
        .float() / 64
    rs = np.random.RandomState(seed)
    n_u, sc, ga = path_ids(rs, rows, n)
    if n > 2:           # the ids 0 and rows-1 and a duplicate run
        raw = np.sort(np.concatenate([[0, rows - 1, rows - 1],
                                      rs.randint(0, rows, n - 3)]))
    else:
        raw = np.sort(rs.randint(0, rows, n))
    pads = np.arange(rows, rows + 3)
    add_ids = np.concatenate([raw, pads]).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    sc, ga, add_ids = t(sc), t(ga), t(add_ids)
    src = torch.randint(-512, 512, (n, D), generator=g, device=dev) \
        .float() / 1024
    set_src = torch.where((sc < rows)[:, None], src, table[rows - 1])
    add_src = torch.cat([torch.randint(-512, 512, (n, D), generator=g,
                                       device=dev).float() / 1024,
                         torch.zeros(3, D, device=dev)])
    got = {"gather": sk.embedding_gather(table, ga),
           "set": sk.embedding_scatter(table.clone(), sc, set_src, "set"),
           "add": sk.embedding_scatter(table.clone(), add_ids, add_src,
                                       "add")}
    want = {"gather": sk.embedding_gather_plain(table, ga),
            "set": sk.embedding_scatter_plain(table.clone(), sc, set_src,
                                              "set"),
            "add": sk.embedding_scatter_plain(table.clone(), add_ids,
                                              add_src, "add")}
    torch.cuda.synchronize()
    errs = {k: (got[k] - want[k]).abs().max().item() for k in got}
    same = {k: torch.equal(got[k], want[k]) for k in got}
    log("embedding kernels rows %d D %d n %d (%d unique, pads, duplicates, "
        "ids 0 and rows-1): max_abs_err %s (tolerance 0: exact inputs)"
        % (rows, D, n, n_u, ", ".join("%s=%.3g" % kv for kv in errs.items())))
    check(all(same.values()), "embedding kernels disagree with their plain "
          "versions at rows %d D %d n %d: %s" % (rows, D, n, same))
    return dict(table=table, sc=sc, ga=ga, set_src=set_src, add_ids=add_ids,
                add_src=add_src, n_u=n_u, errs=errs,
                add_rows=int(torch.unique(add_ids.clamp(max=rows - 1))
                             .numel()))


def phase_embedding(torch, kernels, sk, timer, card):
    """B5 and B6 against their plain versions at the recommender path's
    shapes (bench and Criteo geometries, timed) and at ragged shapes."""
    dev = torch.device("cuda")
    for rows, D, n in ((1000, 13, 257), (50, 16, 1), (77, 64, 40),
                       (3, 1, 9)):
        embed_case(torch, sk, rows, D, n, rows + D + n, dev)
    out = []
    src = "mxnet_tpu_torch/csrc/embedding.cu"
    for tag, geo in (("bench", REC), ("criteo", CRITEO)):
        rows, D, n, F = geo["rows"], geo["dim"], geo["batch"], geo["tables"]
        c = embed_case(torch, sk, rows, D, n, 7, dev)
        table, sc, ga = c["table"], c["sc"], c["ga"]
        shape = "%s: table (%d, %d) f32, n %d (%d unique + pads)" % (
            tag, rows, D, n, c["n_u"])
        row_b = D * 4
        # distinct rows the set scatter writes: the unique ids, and the
        # last row once more where the pads form a run of their own
        set_rows = c["n_u"] + int(rows - 1 not in set(
            sc[:c["n_u"]].tolist()))
        b_g, by_g = bound_ms(n * 4 + 2 * n * row_b, 0)
        b_s, by_s = bound_ms(n * 4 + n * row_b + set_rows * row_b, 0)
        na = c["add_ids"].numel()
        b_a, by_a = bound_ms(na * 4 + na * row_b + 2 * c["add_rows"] * row_b,
                             na * D)
        ga_l, sc_l = ga.long(), sc.clamp(max=rows - 1).long()
        add_l = c["add_ids"].clamp(max=rows - 1).long()
        t_set, t_add = table.clone(), table.clone()
        out += [{
            "name": "embedding_gather", "route": "cuda", "source": src,
            "replaces": "mxnet_tpu/sparse/kernels.py:117",
            "shape": shape + ", one segment (lookup / apply_sgd / "
                     "apply_adam alone; not on the step's path)",
            "launches_per_step": 0,
            "max_abs_err": c["errs"]["gather"],
            "ms": timer(lambda: sk.embedding_gather(table, ga)),
            "plain_ms": timer(lambda: sk.embedding_gather_plain(table, ga)),
            "bound_ms": b_g, "bound_by": by_g,
            "library_ms": timer(lambda: torch.index_select(table, 0, ga_l)),
            "library_call": "torch.index_select(table, 0, ids)",
        }, {
            "name": "embedding_scatter", "route": "cuda", "source": src,
            "replaces": "mxnet_tpu/sparse/kernels.py:175",
            "shape": shape + ", set", "launches_per_step": 2 * F,
            "max_abs_err": c["errs"]["set"],
            "ms": timer(lambda: sk.embedding_scatter(t_set, sc, c["set_src"],
                                                     "set")),
            "plain_ms": timer(lambda: sk.embedding_scatter_plain(
                t_set, sc, c["set_src"], "set")),
            "bound_ms": b_s, "bound_by": by_s,
            "library_ms": timer(lambda: t_set.index_copy_(0, sc_l,
                                                          c["set_src"])),
            "library_call": "table.index_copy_(0, clamped ids, rows)",
        }, {
            "name": "embedding_scatter", "route": "cuda", "source": src,
            "replaces": "mxnet_tpu/sparse/kernels.py:175",
            "shape": "%s: table (%d, %d) f32, n %d sorted with duplicates + "
                     "3 pads, add (not on the step's path)" % (tag, rows, D,
                                                               na - 3),
            "launches_per_step": 0,
            "max_abs_err": c["errs"]["add"],
            "ms": timer(lambda: sk.embedding_scatter(
                t_add, c["add_ids"], c["add_src"], "add")),
            "plain_ms": timer(lambda: sk.embedding_scatter_plain(
                t_add, c["add_ids"], c["add_src"], "add")),
            "bound_ms": b_a, "bound_by": by_a,
            "library_ms": timer(lambda: t_add.index_add_(0, add_l,
                                                         c["add_src"])),
            "library_call": "table.index_add_(0, clamped ids, rows)",
        }]
        del c, table, t_set, t_add
        out += gather_groups(torch, sk, timer, tag, geo, dev)
    for r in out:
        log("  %-18s %-62s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "library_ms=%s%s  [%s]"
            % (r["name"], r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
               r["bound_by"], "none" if r["library_ms"] is None
               else "%.4f" % r["library_ms"],
               "" if "per_table_ms" not in r else
               "; one launch per table %.4f, one index_select per table "
               "%.4f (back to back); host ms per call %.4f, per-table "
               "calls %.4f" % (r["per_table_ms"], r["library_sum_ms"],
                               r["host_ms"], r["per_table_host_ms"]), card))
    return out


def gather_groups(torch, sk, timer, tag, geo, dev):
    """The recommender step's two grouped gathers at ``geo``: the lookup
    (one segment per table) and the update (each table's weight and
    momentum rows), over distinct tables and momentum slots, with the
    step's ids (sorted unique + pads, clamped).  Each is held to the
    plain version exactly and timed beside the same segments as one
    kernel launch per table (the design before) and as one
    ``index_select`` per table."""
    rows, D, n, F = geo["rows"], geo["dim"], geo["batch"], geo["tables"]
    g = torch.Generator(device=dev).manual_seed(11)
    bufs = [torch.randint(-64, 64, (rows, D), generator=g, device=dev)
            .float() / 64 for _ in range(2 * F)]
    rs = np.random.RandomState(11)
    ids = [torch.from_numpy(path_ids(rs, rows, n)[2]).to(dev)
           for _ in range(F)]
    out = []
    for phase_name, tabs, idx in (
            ("lookup", bufs[:F], ids),
            ("update", [b for f in range(F) for b in (bufs[f], bufs[F + f])],
             [i for i in ids for _ in range(2)])):
        m = len(tabs)
        got = sk.embedding_gather_many(tabs, idx)
        want = sk.embedding_gather_many_plain(tabs, idx)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              "the grouped gather differs from its plain version (%s %s)"
              % (tag, phase_name))
        del got, want
        longs = [i.long() for i in idx]
        b, by = bound_ms(m * (n * 4 + 2 * n * D * 4), 0)
        out.append({
            "name": "embedding_gather", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/embedding.cu",
            "replaces": "mxnet_tpu/sparse/kernels.py:117",
            "shape": "%s %s: %d segments, tables (%d, %d) f32, n %d each, "
                     "grouped" % (tag, phase_name, m, rows, D, n),
            "launches_per_step": 1, "max_abs_err": err,
            "ms": timer(lambda: sk.embedding_gather_many(tabs, idx)),
            "plain_ms": timer(lambda: sk.embedding_gather_many_plain(tabs,
                                                                     idx)),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "library_call": "none: no single PyTorch call gathers from "
                            "many tables",
            "per_table_ms": timer(lambda: [sk.embedding_gather(t, i)
                                           for t, i in zip(tabs, idx)]),
            "library_sum_ms": timer(lambda: [torch.index_select(t, 0, i)
                                             for t, i in zip(tabs, longs)]),
            "host_ms": host_ms(torch, lambda: sk.embedding_gather_many(
                tabs, idx), 10),
            "per_table_host_ms": host_ms(torch, lambda: [
                sk.embedding_gather(t, i) for t, i in zip(tabs, idx)], 10),
        })
    del bufs
    return out


def rec_batch(torch, geo, seed, dev):
    rs = np.random.RandomState(seed)
    B, F = geo["batch"], geo["tables"]
    b = {"ids": rs.randint(0, geo["rows"], (F, B)).astype(np.int32),
         "dense": rs.rand(B, geo["dense"]).astype(np.float32),
         "label": (rs.rand(B) > 0.5).astype(np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def phase_rec_parity(torch, tsp, MeshSpec, make_mesh, convert, card):
    """Two recommender steps on the card and on the CPU (plain versions)
    from the same state: 4 tables x 1000 x 16, batch 512."""
    geo = dict(REC, rows=1000, batch=512)
    F = geo["tables"]
    batches = [rec_batch(torch, geo, 20 + i, "cpu") for i in range(2)]
    res = {}
    start = None
    for dev in ("cpu", "cuda"):
        spec = MeshSpec(make_mesh((1,), ("dp",), device=dev))
        embs = [tsp.ShardedEmbedding(geo["rows"], geo["dim"], spec,
                                     name="par%d" % f) for f in range(F)]
        if start is None:
            start = convert.recommender_state_to_numpy(tsp.recommender_state(
                embs, dense_dim=geo["dense"], hidden=geo["hidden"], seed=3))
        state = convert.recommender_state_from_numpy(start, dev)
        step = tsp.make_recommender_step(embs, lr=geo["lr"],
                                         momentum=geo["momentum"])
        losses = []
        for b in batches:
            state, loss = step(state, {k: v.to(dev) for k, v in b.items()})
            losses.append(float(loss))
        res[dev] = (convert.recommender_state_to_numpy(state), losses)
    (cpu, l_cpu), (card_s, l_card) = res["cpu"], res["cuda"]
    worst = 0.0
    pairs = [("%s[%d]" % (p, i), a, b, start[p][i]) for p in ("tables",
                                                             "moms")
             for i, (a, b) in enumerate(zip(cpu[p], card_s[p]))]
    pairs += [("%s.%s" % (p, k), cpu[p][k], card_s[p][k], start[p][k])
              for p in ("mlp", "mlp_mom") for k in cpu[p]]
    for name, a, b, s0 in pairs:
        upd = np.abs(a - s0).max()
        err = np.abs(a - b).max()
        worst = max(worst, err / upd)
        check(err <= 1e-3 * upd, "recommender %s on the card differs from "
              "the CPU by %.3g; its largest update is %.3g" % (name, err,
                                                              upd))
    lerr = max(abs(a - b) for a, b in zip(l_cpu, l_card))
    log("recommender 2 steps card vs cpu (%d x %d x %d, batch %d): every "
        "table, momentum and MLP tensor within %.3g of its largest update "
        "(tolerance 1e-3: f32 both sides, duplicate-id gradient sums in "
        "another order, cuBLAS vs CPU BLAS); losses %s vs %s, max diff "
        "%.3g (tolerance 1e-5) [%s]"
        % (F, geo["rows"], geo["dim"], geo["batch"], worst,
           ["%.7f" % v for v in l_card], ["%.7f" % v for v in l_cpu], lerr,
           card))
    check(lerr <= 1e-5, "recommender losses on the card differ from the CPU")


def rec_run(torch, kernels, tsp, MeshSpec, make_mesh, geo, warm, timed,
            card, dtype="float32"):
    """Train the recommender at ``geo`` on the card, its tables in
    ``dtype`` (their momentum float32): ``warm`` + ``timed`` steps that
    each read their loss, one step under ``set_sync_debug_mode("error")``
    and one profiled step; checks the launch counts exactly and returns
    them with the median step ms."""
    F, B = geo["tables"], geo["batch"]
    tag = "%d tables x %d x %d %s, batch %d" % (F, geo["rows"], geo["dim"],
                                               dtype, B)
    spec = MeshSpec(make_mesh((1,), ("dp",)))
    embs = [tsp.ShardedEmbedding(geo["rows"], geo["dim"], spec,
                                 dtype=dtype, name="table%d" % f)
            for f in range(F)]
    t0 = time.perf_counter()
    state = tsp.recommender_state(embs, dense_dim=geo["dense"],
                                  hidden=geo["hidden"], seed=0)
    torch.cuda.synchronize()
    log("recommender_state(%s, seed=0): %.2f GB of tables and %.2f GB of "
        "momentum, %.1f s" % (tag, sum(e.table_bytes for e in embs) / 1e9,
                              sum(m.numel() * 4 for m in state["moms"])
                              / 1e9, time.perf_counter() - t0))
    batch = rec_batch(torch, geo, 0, "cuda")
    step = tsp.make_recommender_step(embs, lr=geo["lr"],
                                     momentum=geo["momentum"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times, losses = [], []
    for _ in range(warm + timed):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses.append(float(loss))
    log("one step under torch.cuda.set_sync_debug_mode('error'): no host "
        "synchronisation before the loss read")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        prof_ms = (time.perf_counter() - t0) * 1e3
    steps = warm + timed + 2
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("launches on the recommender path (%s): %s over %d steps"
        % (tag, got, steps))
    check(got["embedding_gather"] == 2 * steps,
          "embedding_gather launched %d times over %d steps, want %d (one "
          "grouped lookup and one grouped update gather per step)"
          % (got["embedding_gather"], steps, 2 * steps))
    # a set scatter per table and buffer: the table's in its dtype's
    # count, the float32 momentum's in embedding_scatter
    suffix = tsp.kernels._DTYPES[getattr(torch, dtype)][1]
    want = {"embedding_scatter": F * steps}
    want["embedding_scatter" + suffix] = \
        want.get("embedding_scatter" + suffix, 0) + F * steps
    for key, n_want in want.items():
        check(got[key] == n_want, "%s launched %d times over %d steps, "
              "want %d (two scatters per table)" % (key, got[key], steps,
                                                    n_want))
    tt = times[warm:]
    med = statistics.median(tt)
    log("recommender %s: warm-up %s ms; timed %d steps median %.3f ms "
        "(spread %.3f-%.3f) = %.1f examples/s [%s]"
        % (tag, ", ".join("%.1f" % t for t in times[:warm]), timed, med,
           min(tt), max(tt), B / med * 1e3, card))
    by_kernel = device_by_kernel(prof)
    if by_kernel:
        busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
        log("device time of one step by kernel (torch.profiler) [%s]:"
            % card)
        for key, (us, cnt) in sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:12]:
            log("  %9.1f us  x%-4d %s" % (us, cnt, key[:90]))
        groups = {"embedding kernels": 0.0, "sort (dedup)": 0.0,
                  "matmuls": 0.0, "everything else": 0.0}
        for key, (us, _cnt) in by_kernel.items():
            group = ("embedding kernels" if ("gather_kernel" in key or
                                             "scatter_kernel" in key)
                     else "sort (dedup)" if "sort" in key.lower()
                     or "radix" in key.lower()
                     else "matmuls" if "gemm" in key.lower()
                     else "everything else")
            groups[group] += us / 1e3
        log("  by group: %s" % ", ".join("%s %.3f ms" % kv
                                         for kv in groups.items()))
        log("  device busy %.3f ms of the profiled step's %.3f ms: idle "
            "share %.3f; %d device kernels and copies in the step"
            % (busy_ms, prof_ms, 1 - busy_ms / prof_ms,
               sum(cnt for _us, cnt in by_kernel.values())))
    else:
        log("device busy: not measured (the profiler saw no device time)")
    log("peak memory allocated %.2f GB; loss on the repeated batch before "
        "%.6f, after %d steps %.6f [%s]"
        % (peak / 1e9, losses[0], steps - 1, losses[-1], card))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the recommender did not lower its loss on the repeated batch "
          "(%.6f -> %.6f)" % (losses[0], losses[-1]))
    del state, embs
    return got, med


# the LM's pushes per step under Module.fit (GPT-2-small, 198 keys): the
# shapes B7 sees and how many keys have each
TWO_BIT_PUSHES = [((32768, 768), 2), ((3072, 768), 12), ((768, 3072), 12),
                  ((768, 768), 48), ((1024, 768), 1), ((32768,), 1),
                  ((3072,), 12), ((768,), 110)]


@functools.lru_cache(maxsize=None)
def resnet50_pushes():
    """ResNet-50's pushes per Module.fit step (224², 1000 classes, f16;
    157 keys, 25,549,486 elements), read off the symbol phase 24 trains:
    the shapes B10 sees and how many keys have each, most common first."""
    from collections import Counter
    from mxnet_tpu_torch.models import resnet
    net = resnet.get_symbol(**dict(RESNET50, dtype="float16"))
    args, _, _ = net.infer_shape(data=(RESNET_BATCH, 3, 224, 224),
                                 softmax_label=(RESNET_BATCH,))
    return Counter(
        tuple(s) for n, s in zip(net.list_arguments(), args)
        if n not in ("data", "softmax_label")).most_common()


def two_bit_case(torch, kernels, n, threshold, seed, offset=0, edges=()):
    """B7 against its plain version on ``n`` elements (a view ``offset``
    floats into its buffer, so misaligned when ``offset`` % 4), exactly;
    ``edges`` are placed in the residual with a zero gradient.  Returns
    (grad, residual, max_abs_err)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(n + offset, generator=gen, device="cuda")[offset:] * 0.5
    r = torch.randn(n + offset, generator=gen, device="cuda")[offset:] * 0.2
    if len(edges):
        e = torch.tensor(edges, dtype=torch.float32, device="cuda")
        e = e.repeat(-(-min(n, 4096) // e.numel()))[:min(n, 4096)]
        g[:e.numel()] = 0.0
        r[:e.numel()] = e
    q0, r0 = kernels.two_bit_compress_plain(g, r, threshold)
    q, r1 = kernels.two_bit_compress(g, r.clone(), threshold)
    torch.cuda.synchronize()
    nan = torch.isnan(r0)
    same = (torch.equal(q, q0) and torch.equal(torch.isnan(r1), nan)
            and torch.equal(r1[~nan], r0[~nan]))
    err = max((q - q0).abs().max().item(),
              (r1[~nan] - r0[~nan]).abs().max().item() if n else 0.0)
    check(same, "two_bit_compress differs from its plain version at n %d, "
          "threshold %r, offset %d: max_abs_err %.3g" % (n, threshold,
                                                         offset, err))
    return g, r, err


def phase_two_bit(torch, kernels, timer, card):
    """B7 against its plain version, exactly, at every shape the LM's
    pushes give it (timed, with bounds) and at edge cases: n 1 and 1023,
    a tail (25,165,827), misaligned views, threshold 0.3 at f32(0.3) and
    its nextafter neighbours, NaN and +-inf."""
    for t in (0.5, 0.3):
        t32 = np.float32(t)
        edges = [t32, np.nextafter(t32, np.float32(1)),
                 np.nextafter(t32, np.float32(0)), -t32,
                 -np.nextafter(t32, np.float32(1)), 0.0, np.nan, np.inf,
                 -np.inf]
        for n, offset in ((1, 0), (1023, 0), (25165827, 0), (4099, 1),
                          (4099, 2), (4099, 3), (1023, 1)):
            two_bit_case(torch, kernels, n, t, n + offset, offset,
                         edges=[float(x) for x in edges])
    log("two_bit_compress vs plain: n 1, 1023, 25165827, misaligned views "
        "(offsets 1-3), thresholds 0.5 and 0.3 with f32(t) and its "
        "nextafter neighbours, NaN, +-inf: equal (tolerance 0)")
    out = []
    for shape, per_step in TWO_BIT_PUSHES:
        n = int(np.prod(shape))
        g, r, err = two_bit_case(torch, kernels, n, 0.5, n)
        b, by = bound_ms(16 * n, 2 * n)
        out.append({
            "name": "two_bit_compress", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/two_bit.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:121",
            "shape": "grad/residual %s f32, threshold 0.5, one segment "
                     "(%d keys of the push have this shape)"
                     % (shape, per_step),
            "launches_per_step": 0, "max_abs_err": err,
            "ms": timer(lambda: kernels.two_bit_compress(g, r, 0.5)),
            "plain_ms": timer(lambda: kernels.two_bit_compress_plain(
                g, r, 0.5)),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "library_call": "none: no single PyTorch call computes q and "
                            "the new residual"})
        del g, r
    out.append(two_bit_group(torch, kernels, timer))
    for r in out:
        log("  %-16s %-64s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s)%s "
            "[%s]" % (r["name"], r["shape"], r["ms"], r["plain_ms"],
                      r["bound_ms"], r["bound_by"],
                      " per-key launches %.4f" % r["per_key_ms"]
                      if "per_key_ms" in r else "", card))
    g = out[-1]
    per_key_sum = sum(r["ms"] * p for r, (_, p) in zip(out, TWO_BIT_PUSHES))
    log("two_bit_compress per LM step: %d grouped launch(es) over %d keys, "
        "%.4f ms (%.0f%% of the HBM rate) against a %.4f ms bound; one "
        "launch per key: %.4f ms summed over the one-segment rows (each "
        "timed alone), %.4f ms as 198 launches back to back; host ms per "
        "push %.3f grouped, %.3f one call per key [%s]"
        % (g["launches_per_step"], sum(p for _, p in TWO_BIT_PUSHES),
           g["ms"], 100 * g["bound_ms"] / g["ms"], g["bound_ms"],
           per_key_sum, g["per_key_ms"], g["host_ms"],
           g["per_key_host_ms"], card))
    return out


def two_bit_group(torch, kernels, timer, dev="cuda"):
    """B7 over every key of the LM's push (``TWO_BIT_PUSHES``, 198 keys)
    in one grouped call, held to the plain version exactly, timed beside
    the same keys launched one per key (the design before)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    shapes = [s for s, k in TWO_BIT_PUSHES for _ in range(k)]
    gs = [torch.randn(s, generator=gen, device=dev) * 0.5 for s in shapes]
    rs_ = [torch.randn(s, generator=gen, device=dev) * 0.2 for s in shapes]
    q0, r0 = kernels.two_bit_compress_many_plain(gs, rs_, 0.5)
    before = kernels.LAUNCHES["two_bit_compress"]
    qs = kernels.two_bit_compress_many(gs, rs_, 0.5)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["two_bit_compress"] - before
    per = kernels.two_bit_segments_per_launch()
    check(launches == -(-len(shapes) // per), "the grouped two_bit_compress "
          "made %d launches for %d keys at %d per launch"
          % (launches, len(shapes), per))
    err = max(max((a - b).abs().max().item() for a, b in zip(qs, q0)),
              max((a - b).abs().max().item() for a, b in zip(rs_, r0)))
    check(all(torch.equal(a, b) for a, b in zip(qs, q0))
          and all(torch.equal(a, b) for a, b in zip(rs_, r0)),
          "the grouped two_bit_compress differs from its plain version")
    del qs, q0, r0
    n = sum(int(np.prod(s)) for s in shapes)
    b, by = bound_ms(16 * n, 2 * n)
    return {
        "name": "two_bit_compress", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/two_bit.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:121",
        "shape": "the LM's push: %d keys, %d elements f32, threshold 0.5, "
                 "grouped" % (len(shapes), n),
        "launches_per_step": launches, "max_abs_err": err,
        "ms": timer(lambda: kernels.two_bit_compress_many(gs, rs_, 0.5)),
        "plain_ms": timer(lambda: kernels.two_bit_compress_many_plain(
            gs, rs_, 0.5)),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "library_call": "none: no single PyTorch call computes q and the "
                        "new residual",
        "per_key_ms": timer(lambda: [kernels.two_bit_compress(g, r, 0.5)
                                     for g, r in zip(gs, rs_)]),
        "host_ms": host_ms(torch, lambda: kernels.two_bit_compress_many(
            gs, rs_, 0.5), 10),
        "per_key_host_ms": host_ms(torch, lambda: [
            kernels.two_bit_compress(g, r, 0.5) for g, r in zip(gs, rs_)],
            3)}


def record_pushes(torch, kv_mod):
    """Wrap the store's two-bit compressor (``compress_many``: every key
    of a push in one call) to log, per key, the key and (g, r before, q,
    r after) on the host.  Returns (log, undo)."""
    cls = kv_mod._TwoBitCompressor
    orig = cls.compress_many
    pushes = []

    def host(t):
        return t.detach().to("cpu", copy=True)

    def compress_many(self, keys, grads):
        before = [torch.zeros(g.shape) if self.residual.get(k) is None
                  else host(self.residual[k]) for k, g in zip(keys, grads)]
        qs = orig(self, keys, grads)
        for k, g, r0, q in zip(keys, grads, before, qs):
            pushes.append((k, host(g), r0, host(q),
                           host(self.residual[k])))
        return qs

    cls.compress_many = compress_many
    return pushes, lambda: setattr(cls, "compress_many", orig)


def module_params(net, shapes, seed):
    """Seeded parameters (numpy) for ``net`` as host NDArrays: weights
    N(0, 0.05), LayerNorm gammas 1, biases and betas 0."""
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    args = {}
    for name, shp in zip(net.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("gamma"):
            v = np.ones(shp, np.float32)
        elif name.endswith(("bias", "beta")):
            v = np.zeros(shp, np.float32)
        else:
            v = (rs.normal(0, 0.05, shp)).astype(np.float32)
        args[name] = v
    return args


def phase_module_parity(torch, mx, kernels, kv_mod, get_symbol, card):
    """Module.fit for 3 steps through a compressing KVStore("device") on
    the card and on the CPU from the same parameters (a 2-layer LM,
    hidden 64, T 64): every push's q + new residual, q exactly except
    near +-t, the weights, and B7's launch count."""
    cfg = dict(vocab_size=1024, seq_len=64, num_layers=2, hidden=64,
               heads=4)
    B, T, t = 4, cfg["seq_len"], 0.5
    lr, momentum = 0.05, 0.9
    net = get_symbol(**cfg)
    rs = np.random.RandomState(13)
    X = rs.randint(0, cfg["vocab_size"], (3 * B, T)).astype(np.float32)
    Y = rs.randint(0, cfg["vocab_size"], (3 * B, T)).astype(np.float32)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    start = module_params(net, shapes, seed=3)
    res = {}
    for dev in ("cuda", "cpu"):
        ctx = mx.gpu(0) if dev == "cuda" else mx.cpu()
        kv = mx.kv.create("device", device=dev)
        pushes, undo = record_pushes(torch, kv_mod)
        mod = mx.mod.Module(net, context=ctx,
                            compression_params={"type": "2bit",
                                                "threshold": t})
        kernels.reset_launches()
        try:
            mod.fit(mx.io.NDArrayIter(X, Y, batch_size=B), kvstore=kv,
                    optimizer="sgd",
                    optimizer_params={"learning_rate": lr,
                                      "momentum": momentum},
                    eval_metric=mx.metric.Perplexity(ignore_label=None),
                    arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in start.items()},
                    num_epoch=1)
        finally:
            undo()
        launches = kernels.LAUNCHES["two_bit_compress"]
        args, _ = mod.get_params()
        res[dev] = ({k: v.asnumpy() for k, v in args.items()}, pushes,
                    launches)
    n_keys = len(start)
    want = 3 * -(-n_keys // kernels.two_bit_segments_per_launch())
    check(res["cuda"][2] == want,
          "two_bit_compress launched %d times on the card over 3 steps of "
          "%d keys, want %d (one grouped call per push)"
          % (res["cuda"][2], n_keys, want))
    check(res["cpu"][2] == 0, "the CPU run launched a kernel")
    near_n = flip_n = fired = 0
    flipped = {}
    worst_sum = 0.0
    for (k1, g1, r1, q1, n1), (k2, g2, r2, q2, n2) in zip(res["cuda"][1],
                                                          res["cpu"][1]):
        check(k1 == k2, "push order differs: %s vs %s" % (k1, k2))
        s1, s2 = (q1 + n1).numpy(), (q2 + n2).numpy()
        comp = (g2 + r2).numpy()
        scale = max(float(np.abs(comp).max()), t)
        err = float(np.abs(s1 - s2).max())
        worst_sum = max(worst_sum, err / scale)
        check(err <= 1e-4 * scale, "%s: q + new residual differs card vs "
              "CPU by %.3g (scale %.3g)" % (k1, err, scale))
        near = np.abs(np.abs(comp) - np.float32(t)) <= 1e-4 * scale
        differ = (q1 != q2).numpy()
        check(not (differ & ~near).any(), "%s: q differs away from +-t"
              % k1)
        near_n += int(near.sum())
        flip_n += int(differ.sum())
        fired += int((q1 != 0).sum())
        flipped[k1] = flipped.get(k1, np.zeros(differ.shape, bool)) | differ
    bound = lr / B * 2 * t * 3 / (1 - momentum)
    worst = 0.0
    for name, w0 in start.items():
        a, b = res["cuda"][0][name], res["cpu"][0][name]
        upd = float(np.abs(b - w0).max())
        mask = flipped.get(name, np.zeros(w0.shape, bool))
        err = float(np.abs(np.where(mask, b, a) - b).max())
        check(err <= 1e-3 * upd, "%s: card and CPU weights differ by %.3g, "
              "its largest update is %.3g" % (name, err, upd))
        check((np.abs(a - b)[mask] <= bound).all(), "%s: a flipped element "
              "moved more than one flip's update" % name)
        if upd:
            worst = max(worst, err / upd)
    log("Module.fit card vs cpu, L2 h64 T64 batch 4, 3 steps through a "
        "compressing KVStore (%d keys, %d B7 launches on the card, %d "
        "values fired): q + new residual within %.3g of its scale "
        "(tolerance 1e-4), q equal except %d of %d elements within the "
        "tolerance of +-t; weights within %.3g of each tensor's largest "
        "update (tolerance 1e-3) [%s]"
        % (n_keys, res["cuda"][2], fired, worst_sum, flip_n, near_n, worst,
           card))


def phase_module_fit(torch, mx, kernels, kv_mod, get_symbol, trainer_ms,
                     card):
    """Module.fit of the full-width LM through a compressing
    KVStore("device"): 16 numpy-seeded sequences (2 batches of 8 per
    epoch), 2 warm-up steps, 12 timed, one profiled epoch, then one
    epoch whose pushes count the fired values.  The timed and profiled
    steps run the user's path as it is: per step one CUDA event and two
    host clock reads around update(), and nothing on the device."""
    cfg = TRAIN
    B, T = 8, cfg["seq_len"]
    warm, timed = 2, 12
    epochs = (warm + timed + 4) // 2   # + one profiled, one counted epoch
    counted = (2 * epochs - 1, 2 * epochs)     # the steps that count q
    net = get_symbol(**cfg)
    rs = np.random.RandomState(0)
    X = rs.randint(0, cfg["vocab_size"], (2 * B, T)).astype(np.float32)
    Y = rs.randint(0, cfg["vocab_size"], (2 * B, T)).astype(np.float32)
    it = mx.io.NDArrayIter(X, Y, batch_size=B, label_name="softmax_label")
    threshold = 0.5
    mod = mx.mod.Module(net, compression_params={"type": "2bit",
                                                 "threshold": threshold})
    kv = mx.kv.create("device")
    # fired values per step, counted on the card as the pushes of the
    # last epoch go (after the timed and profiled steps: the count adds
    # two launches per key and a host read per step)
    fired = torch.zeros((), dtype=torch.int64, device="cuda")
    cls = kv_mod._TwoBitCompressor
    orig = cls.compress_many

    def counting(self, keys, grads):
        qs = orig(self, keys, grads)
        for q in qs:
            fired.add_(torch.count_nonzero(q))
        return qs

    update_ms = []
    orig_update = mod.update

    def timed_update():
        t0 = time.perf_counter()
        orig_update()
        update_ms.append((time.perf_counter() - t0) * 1e3)

    mod.update = timed_update
    from torch.profiler import ProfilerActivity, profile
    ev, host_t, fired_n, launches, ppl = [], [], [], [], []
    prof = {}
    n_elem = []

    def on_batch(p):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)
        host_t.append(time.perf_counter())
        launches.append(kernels.LAUNCHES["two_bit_compress"])
        if p.nbatch == 1:
            ppl.append(p.eval_metric.get()[1])
        step = len(ev)
        if step in counted:
            fired_n.append(int(fired.item()))
            fired.zero_()
        if step == counted[0] - 2:
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif step == counted[0] - 1:
            torch.cuda.synchronize()
            prof["wall"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].__exit__(None, None, None)
            cls.compress_many = counting

    torch.manual_seed(0)
    mx.random.seed(0)             # the initializers' host stream
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t_fit = time.perf_counter()
    try:
        mod.fit(it, kvstore=kv, optimizer="sgd",
                optimizer_params={"learning_rate": 1e-4, "momentum": 0.9},
                initializer=mx.init.Xavier(),
                eval_metric=mx.metric.Perplexity(ignore_label=None),
                batch_end_callback=on_batch, num_epoch=epochs)
    finally:
        cls.compress_many = orig
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_keys = len(mod._exec_group.param_names)
    n_params = sum(int(np.prod(a.shape)) for a in
                   mod.get_params()[0].values())
    steps = len(ev)
    check(steps == 2 * epochs, "fit ran %d steps, want %d"
          % (steps, 2 * epochs))
    per_step = -(-n_keys // kernels.two_bit_segments_per_launch())
    check(got["two_bit_compress"] == per_step * steps,
          "two_bit_compress launched %d times over %d steps of %d keys, "
          "want %d per step (one grouped call per push)"
          % (got["two_bit_compress"], steps, n_keys, per_step))
    for key in ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv"):
        check(got[key] == cfg["num_layers"] * steps,
              "%s launched %d times over %d steps" % (key, got[key], steps))
    # step i (1-based) ends at ev[i-1]; a step that starts an epoch also
    # carries the previous epoch's end (get_params / set_params)
    inner, crossing = [], []
    for i in range(warm + 1, warm + timed + 1):
        ms = ev[i - 2].elapsed_time(ev[i - 1])
        (crossing if i % 2 == 1 else inner).append(ms)
    med = statistics.median(inner)
    share = [f / n_params for f in fired_n]
    log("Module.fit L%d h%d V%d T%d batch %d f32, KVStore('device') with "
        "2-bit compression (threshold %g), %d keys, %.1f M parameters: "
        "%d steps in %.1f s" % (cfg["num_layers"], cfg["hidden"],
                                cfg["vocab_size"], T, B, threshold, n_keys,
                                n_params / 1e6, steps, fit_s))
    log("  step ms (CUDA events at batch end), timed steps inside an "
        "epoch: %s; median %.3f (spread %.3f-%.3f) = %.0f tokens/s; steps "
        "that start an epoch (+ the epoch-end parameter sync): %s, median "
        "%.3f [%s]" % (", ".join("%.3f" % x for x in inner), med,
                       min(inner), max(inner), B * T / med * 1e3,
                       ", ".join("%.3f" % x for x in crossing),
                       statistics.median(crossing), card))
    log("  ShardedTrainer step of phase 8 in this run: %.3f ms; the "
        "Module/KVStore layer adds %.3f ms per step (%.1f%%)"
        % (trainer_ms, med - trainer_ms, 100 * (med - trainer_ms)
           / trainer_ms))
    log("  host ms in update() per step: %s (median %.2f)"
        % (", ".join("%.1f" % x for x in update_ms[warm:warm + timed]),
           statistics.median(update_ms[warm:warm + timed])))
    log("  two_bit_compress launches per step: %s; fired share (q != 0) "
        "in steps %s (counted after the timed window): %s"
        % (", ".join(str(b - a) for a, b in zip([0] + launches, launches)),
           "/".join(map(str, counted)), ", ".join("%.5f" % s for s in share)))
    log("  perplexity per epoch (both batches, before each update): %s"
        % ", ".join("%.2f" % x for x in ppl))
    by_kernel = {k: (us / 1e3, cnt)
                 for k, (us, cnt) in device_by_kernel(prof["p"]).items()}
    busy = sum(ms for ms, _ in by_kernel.values())
    if busy:
        groups = dict.fromkeys(("two_bit_compress", "flash kernels",
                                "matmuls", "everything else"), 0.0)
        for key, (ms, _cnt) in by_kernel.items():
            groups["two_bit_compress" if "two_bit" in key else
                   "flash kernels" if "flash_" in key else
                   "matmuls" if "gemm" in key else "everything else"] += ms
        log("  profiled step: device busy %.1f ms of %.1f ms, idle share "
            "%.3f; %d kernels and copies on the device; by group: %s [%s]"
            % (busy, prof["wall"], 1 - busy / prof["wall"],
               sum(c for _, c in by_kernel.values()),
               ", ".join("%s %.3f ms" % kv for kv in groups.items()), card))
        for key, (ms, cnt) in sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:12]:
            log("    %9.3f ms  x%-5d %s" % (ms, cnt, key[:90]))
    else:
        log("  device busy: not measured (the profiler saw no device time)")
    log("  peak memory allocated %.2f GB [%s]" % (peak / 1e9, card))
    check(max(share) > 0, "2-bit quantization fired on no step at "
          "threshold %g" % threshold)
    first, last = ppl[warm // 2], ppl[(warm + timed) // 2 - 1]
    check(np.isfinite(first) and np.isfinite(last) and last < first,
          "perplexity did not fall over the timed steps (%.4f -> %.4f)"
          % (first, last))
    del mod, kv
    return got



# B8: the user kernels of mxnet_tpu_torch/csrc/rtc_kernels.cu through
# rtc.CudaModule: bytes each moves and f32 operations per element
RTC_COST = {"axpy": (12, 2), "doubled": (8, 1), "split_sign": (12, 2),
            "ident": (8, 0), "axpy_inplace": (12, 2), "sgd_mom": (20, 7)}
RTC_SHAPES = ((8, 128), (32768, 768))


# one PyTorch call computing the same function as a user kernel
RTC_LIBRARY = {
    "axpy": ("torch.add(y, x, alpha=2.0)",
             lambda torch, t: torch.add(t["y"], t["x"], alpha=2.0)),
    "doubled": ("torch.mul(x, 2.0)", lambda torch, t: torch.mul(t["x"], 2.0)),
    "ident": ("out.copy_(x)", lambda torch, t: t["out"].copy_(t["x"])),
    "axpy_inplace": ("y.add_(x, alpha=0.3)",
                     lambda torch, t: t["y"].add_(t["x"], alpha=0.3)),
}


def rtc_check(torch, tc, kernel, name, shape, seed):
    """Launch ``kernel`` on fresh tensors; returns (tensors, largest
    difference from the plain version over the arguments it writes)."""
    import mxnet_tpu_torch as mx
    t = tc.rtc_arrays(name, shape, seed, "cuda")
    want = tc.rtc_plain(name, {a: v.clone() for a, v in t.items()})
    tc.rtc_launch(kernel, name, t, mx.gpu(0))
    torch.cuda.synchronize()
    err = max((t[a] - v).abs().max().item() for a, v in want.items())
    same = all(torch.equal(t[a], v) for a, v in want.items())
    return t, err, same


def phase_rtc(torch, mx, kernels, tc, timer, card):
    """B8: one CudaModule of the user kernels compiled by NVRTC for sm_90a
    with --fmad=false; the five of test_rtc.py and the reference's
    docstring at (8, 128) and (32768, 768) f32 against their plain
    versions, exactly (with one --fmad=true build's largest difference
    beside it), timed with a cold L2; the host time per launch; and the
    launches that must raise MXNetError."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.base import MXNetError
    src = tc.rtc_source()
    mod = rtc.CudaModule(src, options=("--fmad=false",))
    fma = rtc.CudaModule(src, options=("--fmad=true",))
    log("rtc.CudaModule(%s): NVRTC compile %.1f ms (--fmad=false), %.1f ms "
        "(--fmad=true), %d-byte sm_90a cubin, options %s"
        % (tc.RTC_SOURCE, mod.compile_ms, fma.compile_ms, len(mod._cubin),
           " ".join(mod.options)))
    rows = []
    for name in tc.RTC_CHECKED:
        k = mod.get_kernel(name, tc.RTC_SIGNATURES[name])
        kf = fma.get_kernel(name, tc.RTC_SIGNATURES[name])
        for shape in RTC_SHAPES:
            seed = int(np.prod(shape)) + len(name)
            t, err, same = rtc_check(torch, tc, k, name, shape, seed)
            check(same, "rtc %s at %s differs from its plain version: "
                  "max_abs_err %.3g" % (name, shape, err))
            _, fma_err, _ = rtc_check(torch, tc, kf, name, shape, seed)
            n = int(np.prod(shape))
            nbytes, ops = RTC_COST[name]
            b, by = bound_ms(nbytes * n, ops * n)
            label, lib = RTC_LIBRARY.get(name, (
                "none: no single PyTorch call writes both outputs", None))
            ctx = mx.gpu(0)
            rows.append({
                "name": "rtc", "route": "cuda",
                "source": tc.RTC_SOURCE, "launcher": "mxnet_tpu_torch/rtc.py",
                "replaces": "mxnet_tpu/rtc.py:74", "user_kernel": name,
                "shape": "%s f32" % (shape,), "max_abs_err": err,
                "fmad_true_max_abs_err": fma_err,
                "ms": timer(lambda: tc.rtc_launch(k, name, t, ctx)),
                "plain_ms": timer(lambda: tc.rtc_plain(name, t)),
                "bound_ms": b, "bound_by": by,
                "library_ms": timer(lambda: lib(torch, t)) if lib else None,
                "library_call": label})
            del t
    for r in rows:
        log("  rtc %-13s %-20s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "library_ms=%s err=%g fmad=true err=%g [%s]"
            % (r["user_kernel"], r["shape"], r["ms"], r["plain_ms"],
               r["bound_ms"], r["bound_by"],
               "%.4f" % r["library_ms"] if r["library_ms"] else "-",
               r["max_abs_err"], r["fmad_true_max_abs_err"], card))
    # host cost of one launch: signature checks, kernelParams, the call
    k = mod.get_kernel("ident", tc.RTC_SIGNATURES["ident"])
    x = mx.nd.NDArray(torch.randn(8, 128, device="cuda"))
    o = mx.nd.NDArray(torch.zeros(8, 128, device="cuda"))
    args, grid, block = [x, o, 1024], (4, 1, 1), (256, 1, 1)
    for _ in range(50):
        k.launch(args, mx.gpu(0), grid, block)
    torch.cuda.synchronize()
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        k.launch(args, mx.gpu(0), grid, block)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    log("rtc CudaKernel.launch host cost: %.2f us per launch (ident at "
        "(8, 128), %d launches back to back) [%s]" % (host_us, reps, card))
    # each of these must raise and launch nothing
    before = kernels.LAUNCHES["rtc"]
    refused = {
        "a CPU context": (args, mx.cpu(), block),
        "a dtype mismatch": ([mx.nd.NDArray(x.handle.double()), o, 1024],
                             mx.gpu(0), block),
        "a non-contiguous NDArray": ([mx.nd.NDArray(x.handle.t()), o, 1024],
                                     mx.gpu(0), block),
        "a 2048-thread block": (args, mx.gpu(0), (2048, 1, 1)),
    }
    for what, (a, ctx, blk) in refused.items():
        try:
            k.launch(a, ctx, grid, blk)
        except MXNetError as e:
            log("  refused %s: %s" % (what, str(e).splitlines()[0][:120]))
        else:
            fail("rtc launch with %s did not raise MXNetError" % what)
    try:
        rtc.CudaModule('extern "C" __global__ void k(float *x) { x[0] = y; }')
    except MXNetError as e:
        log("  refused a source that does not compile: %s"
            % " | ".join(str(e).splitlines()[:2])[:160])
    else:
        fail("a CUDA source that does not compile did not raise MXNetError")
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["rtc"] == before, "a refused launch was counted")
    return rows, host_us, mod.compile_ms


def phase_nd_parity(torch, tc, card):
    """Every op case of the five op modules through mx.nd on the card and
    on the CPU from the same numpy inputs, within the CPU parity tests'
    tolerances; random ops by shape, dtype and same-seed reproducibility
    on the card."""
    worst = {}
    keys = sorted(tc.OP_CASES)
    for key in keys:
        _, case = tc.op_case(key)
        card_out = tc.run_port(key, "cuda")
        cpu_out = tc.run_port(key, "cpu")
        check(len(card_out) == len(cpu_out), "%s: output count" % key)
        for c, h in zip(card_out, cpu_out):
            if case["random"]:
                check(c.shape == h.shape and c.dtype == h.dtype,
                      "%s: %s %s on the card, %s %s on the CPU"
                      % (key, c.shape, c.dtype, h.shape, h.dtype))
                continue
            tol = max(case["tol"], tc.ARITH) if case["tol"] else 0.0
            try:
                err = tc.compare(c, h, tol)
            except AssertionError as e:
                fail("nd.%s on the card vs the CPU: %s" % (key, e))
            worst[tol] = max(worst.get(tol, 0.0), err)
        if case["random"]:
            again = tc.run_port(key, "cuda")
            check(all(np.array_equal(a, b) for a, b in zip(card_out, again)),
                  "%s: the same seed gave other draws on the card" % key)
    # variadic ops built in a Symbol graph (num_args counted by create),
    # evaluated on the card and on the CPU
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.executor import GraphProgram
    rs = np.random.RandomState(16)
    for label, build_sym, shapes in (
            ("concat", lambda a, b: sym.concat(a, b, dim=1), ((3, 2), (3, 4))),
            ("stack", lambda a, b: sym.stack(a, b), ((2, 3), (2, 3))),
            ("add_n", lambda a, b: sym.add_n(a, b), ((2, 3), (2, 3))),
            ("khatri_rao", lambda a, b: sym.khatri_rao(a, b),
             ((3, 2), (4, 2)))):
        g = build_sym(sym.Variable("a"), sym.Variable("b"))
        vals = [rs.randn(*sh).astype(np.float32) for sh in shapes]
        outs = [GraphProgram(g).evaluate(
            [torch.from_numpy(v).to(d) for v in vals], [])[0][0].cpu()
            for d in ("cuda", "cpu")]
        check(torch.allclose(outs[0], outs[1], rtol=0, atol=1e-6),
              "sym.%s on the card vs the CPU" % label)
    log("nd ops card vs cpu: %d cases (%d random) agree; largest "
        "difference by tolerance: %s [%s]"
        % (len(keys), sum(tc.op_case(k)[1]["random"] for k in keys),
           ", ".join("tol %g: %.3g" % kv for kv in sorted(worst.items())),
           card))


def phase_imperative(torch, mx, kernels, tc, get_symbol, timer, card):
    """The imperative path at the full width of the LM: its 198 parameter
    arrays as mx.nd arrays on the card from mx.random.seed(0) with
    nd.random.normal (gradients and momenta likewise), a little NDArray
    arithmetic, 5 steps of momentum SGD each launching the user's
    CudaModule kernel sgd_mom once per array, held against
    nd.sgd_mom_update on copies, then nd.save of the updated weights and
    nd.load back, bit for bit."""
    import shutil
    import tempfile
    net = get_symbol(**TRAIN)
    arg_shapes, _, _ = net.infer_shape(data=(8, TRAIN["seq_len"]),
                                       softmax_label=(8, TRAIN["seq_len"]))
    shapes = [(n, tuple(s)) for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")]
    total = sum(int(np.prod(s)) for _, s in shapes)
    check(len(shapes) == 198, "%d parameter arrays, want 198" % len(shapes))
    steps, ctx, hp = 5, mx.gpu(0), tc.SGD
    import gc
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9    # by earlier phases
    kernels.reset_launches()
    t0 = time.perf_counter()
    mx.random.seed(0)
    w = [mx.nd.random.normal(0, 0.02, shape=s, ctx=ctx) for _, s in shapes]
    g = [mx.nd.random.normal(0, 1, shape=s, ctx=ctx) * 1e-3
         for _, s in shapes]
    m = [mx.nd.random.normal(0, 1, shape=s, ctx=ctx) * 1e-4
         for _, s in shapes]
    gnorm = float(np.sqrt(sum(mx.nd.sum(x * x).asscalar() for x in g)))
    head = w[[n for n, _ in shapes].index("head_weight")]
    probe = mx.nd.dot(mx.nd.ones((8, TRAIN["hidden"]), ctx=ctx), head,
                      transpose_b=True)
    check(probe.shape == (8, TRAIN["vocab_size"])
          and np.isfinite(probe.asnumpy()).all(), "nd.dot probe")
    w_ref = [x.copy() for x in w]
    m_ref = [x.copy() for x in m]
    mx.nd.waitall()
    log("imperative: %d arrays, %d parameters (%.1f MB each of w, g, m), "
        "made with nd.random.normal in %.2f s; gradient norm %.6f"
        % (len(shapes), total, total * 4 / 1e6, time.perf_counter() - t0,
           gnorm))
    # the user writes the kernel as a string and compiles it
    mod = mx.rtc.CudaModule(tc.rtc_source(), options=("--fmad=false",))
    k = mod.get_kernel("sgd_mom", tc.RTC_SIGNATURES["sgd_mom"])
    scal = [hp["lr"], hp["momentum"], hp["wd"], hp["rescale"], hp["clip"]]
    launch = []
    for wi, gi, mi in zip(w, g, m):
        n = wi.size
        grid, block = tc.rtc_grid("sgd_mom", n)
        launch.append(([wi, gi, mi] + scal + [n], grid, block))

    def kernel_step():
        for args, grid, block in launch:
            k.launch(args, ctx, grid, block)

    def op_step():
        for wi, gi, mi in zip(w_ref, g, m_ref):
            mx.nd.sgd_mom_update(wi, gi, mi, lr=hp["lr"],
                                 momentum=hp["momentum"], wd=hp["wd"],
                                 rescale_grad=hp["rescale"],
                                 clip_gradient=hp["clip"])

    def run(step_fn):
        dev_ms, host_ms = [], []
        for _ in range(steps):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            s.record()
            step_fn()
            h1 = time.perf_counter()
            e.record()
            e.synchronize()
            dev_ms.append(s.elapsed_time(e))
            host_ms.append((h1 - h0) * 1e3)
        return dev_ms, host_ms

    k_dev, k_host = run(kernel_step)
    got = dict(kernels.LAUNCHES)
    o_dev, o_host = run(op_step)
    peak = torch.cuda.max_memory_allocated() / 1e9 - held
    check(got["rtc"] == steps * len(shapes),
          "sgd_mom launched %d times, want %d" % (got["rtc"],
                                                   steps * len(shapes)))
    worst, equal = 0.0, 0
    for (name, _), a, b, ma, mb in zip(shapes, w, w_ref, m, m_ref):
        for x, y in ((a, b), (ma, mb)):
            scale = y.handle.abs().max().item()
            err = (x.handle - y.handle).abs().max().item()
            check(err <= 1e-6 * scale, "%s: CudaModule SGD vs "
                  "nd.sgd_mom_update differ by %.3g (scale %.3g)"
                  % (name, err, scale))
            worst = max(worst, err / scale)
            equal += torch.equal(x.handle, y.handle)
    nbytes = 5 * 4 * total
    bound = nbytes / HBM_BYTES_S * 1e3
    log("CudaModule sgd_mom vs nd.sgd_mom_update over %d steps: %d of %d "
        "tensors bit-equal, largest difference %.3g of the tensor's largest "
        "magnitude (limit 1e-6)" % (steps, equal, 2 * len(shapes), worst))
    log("per step, %d sgd_mom launches: device %.3f ms median (%.3f-%.3f) "
        "against a %.3f ms bound (%.1f MB at 3.35 TB/s, %.0f%% of it); host "
        "%.3f ms median for the launches; nd.sgd_mom_update: device %.3f ms "
        "(%.3f-%.3f), host %.3f ms; peak memory %.2f GB above the %.2f GB "
        "that earlier phases still hold [%s]"
        % (len(shapes), statistics.median(k_dev), min(k_dev), max(k_dev),
           bound, nbytes / 1e6, 100 * bound / statistics.median(k_dev),
           statistics.median(k_host), statistics.median(o_dev), min(o_dev),
           max(o_dev), statistics.median(o_host), peak, held, card))
    # save the updated weights and load them back
    tmp = tempfile.mkdtemp(prefix="chip_smoke_params_")
    try:
        fname = os.path.join(tmp, "lm-0005.params")
        params = {"arg:" + n: x for (n, _), x in zip(shapes, w)}
        t0 = time.perf_counter()
        mx.nd.save(fname, params)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(fname)
        t0 = time.perf_counter()
        back = mx.nd.load(fname)
        mx.nd.waitall()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(list(back) == list(params), "nd.load: names or order differ")
    for n, x in params.items():
        check(back[n].context == ctx and torch.equal(back[n].handle,
                                                     x.handle),
              "nd.load: %s differs from what was saved" % n)
    log("nd.save of the %d updated weights: %.1f MB in %.2f s; nd.load "
        "back onto the card %.2f s; bit-equal" % (len(params), size / 1e6,
                                                  save_s, load_s))
    # B8's row for the path's kernel, at its largest array
    shape = max((s for _, s in shapes), key=lambda s: int(np.prod(s)))
    t, err, same = rtc_check(torch, tc, k, "sgd_mom", shape, 17)
    check(same, "sgd_mom at %s differs from its plain version" % (shape,))
    fma = mx.rtc.CudaModule(tc.rtc_source(), options=("--fmad=true",))
    _, fma_err, _ = rtc_check(torch, tc, fma.get_kernel(
        "sgd_mom", tc.RTC_SIGNATURES["sgd_mom"]), "sgd_mom", shape, 17)
    n = int(np.prod(shape))
    b, by = bound_ms(RTC_COST["sgd_mom"][0] * n, RTC_COST["sgd_mom"][1] * n)
    row = {"name": "rtc", "route": "cuda", "source": tc.RTC_SOURCE,
           "launcher": "mxnet_tpu_torch/rtc.py",
           "replaces": "mxnet_tpu/rtc.py:74", "user_kernel": "sgd_mom",
           "shape": "w/g/m %s f32 (the largest of the 198)" % (shape,),
           "max_abs_err": err, "fmad_true_max_abs_err": fma_err,
           "ms": timer(lambda: tc.rtc_launch(k, "sgd_mom", t, ctx)),
           "plain_ms": timer(lambda: tc.rtc_plain("sgd_mom", t)),
           "bound_ms": b, "bound_by": by, "library_ms": None,
           "library_call": "none: no single PyTorch call updates w and m",
           "step_ms": statistics.median(k_dev), "step_bound_ms": bound}
    log("  rtc sgd_mom %s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) err=%g "
        "fmad=true err=%g [%s]" % (row["shape"], row["ms"], row["plain_ms"],
                                   b, by, err, fma_err, card))
    del w, g, m, w_ref, m_ref, back, params, t
    return got, row


# ---------------------------------------------------------------------------
# The conv-net training path (phases 18-19): ResNet through ShardedTrainer
# and Module.fit on cuDNN/cuBLAS; no hand-written kernel is on it
# ---------------------------------------------------------------------------

# bench.py's ResNet-50 configuration (bench.py:385-422)
RESNET50 = dict(num_classes=1000, num_layers=50, image_shape="3,224,224")
RESNET_BATCH = 32


def conv_net_shapes(kw, batch, layout):
    c, h, w = (int(v) for v in kw["image_shape"].split(","))
    data = (batch, c, h, w) if layout == "NCHW" else (batch, h, w, c)
    return {"data": data, "softmax_label": (batch,)}


def train_flops(symbol, shapes):
    """FLOPs of one training step from the graph's inferred shapes: 2 x
    the multiply-adds of every Convolution (output elements x C_in/g x
    kernel) and FullyConnected (output elements x input features), x 3
    for the forward, the data gradient and the weight gradient."""
    from mxnet_tpu_torch.executor import _resolve_structs
    prog, _, shapes_of = _resolve_structs(symbol, shapes)
    macs = 0
    for node in prog.nodes:
        if node.is_var or node.op.name not in ("Convolution",
                                               "FullyConnected"):
            continue
        out = shapes_of[id(node)][0].shape
        w = shapes_of[id(node.inputs[1].node)][0].shape
        macs += int(np.prod(out)) * int(np.prod(w[1:]))
    return 2 * 3 * macs


def state_gaps(start, got, want):
    """How far ``got``'s (params, moms, aux) dicts stand from ``want``'s:
    per tensor, the largest difference over the largest change of the
    same tensor in ``want`` from ``start``, worst first; and per part,
    norm-wise, |got - want| over |want - start| of all its tensors as
    one vector."""
    per_tensor, norms = [], {}
    for part, s0, a, b in zip(("params", "moms", "aux"), start, got, want):
        diff2 = change2 = 0.0
        for name in b:
            change = b[name] - s0[name]
            diff = a[name] - b[name]
            per_tensor.append((float(np.abs(diff).max())
                               / max(float(np.abs(change).max()), 1e-12),
                               part, name))
            diff2 += float((diff.astype(np.float64) ** 2).sum())
            change2 += float((change.astype(np.float64) ** 2).sum())
        norms[part] = (diff2 / max(change2, 1e-300)) ** 0.5
    return sorted(per_tensor, reverse=True), norms


def resnet_two_steps(torch, ShardedTrainer, convert, kw, batch, layout,
                     seed=0):
    """Two ShardedTrainer steps of ``resnet.get_symbol(**kw)`` on the card
    and on the CPU from one state: ``state_gaps`` of the card's against
    the CPU's, and both losses."""
    from mxnet_tpu_torch.models import resnet
    net_kw = dict(kw, num_classes=10, layout=layout)
    shapes = conv_net_shapes(net_kw, batch, layout)
    trs = {d: ShardedTrainer(resnet.get_symbol(**net_kw), device=d, lr=0.1,
                             momentum=0.9, wd=1e-4) for d in ("cuda", "cpu")}
    names = (trs["cpu"].param_names, trs["cpu"].prog.aux_names)
    start = convert.trainer_state_to_numpy(
        trs["cpu"].init_state(shapes, seed=3))
    rs = np.random.RandomState(seed)
    batches = [{"data": rs.randn(*shapes["data"]).astype(np.float32),
                "softmax_label": rs.randint(0, 10, batch).astype(np.float32)}
               for _ in range(2)]
    out = {}
    for d, tr in trs.items():
        state = convert.trainer_state_from_numpy(names, start, d)
        for b in batches:
            *state, loss = tr.step(*state, b)
        out[d] = (convert.trainer_state_to_numpy(state), float(loss))
    parts = (names[0], names[0], names[1])
    as_dicts = [tuple(dict(zip(n, part)) for n, part in zip(parts, st))
                for st in (start, out["cuda"][0], out["cpu"][0])]
    per_tensor, norms = state_gaps(*as_dicts)
    return per_tensor, norms, (out["cuda"][1], out["cpu"][1])


def resnet_fwd_grad(torch, ShardedTrainer, kw, batch, seed=1):
    """One training-mode forward and gradient of ``resnet.get_symbol(
    **kw)`` (NCHW) on the card and on the CPU from one state: the largest
    difference of the outputs and new aux states (relative to their
    largest magnitude, or 1), and the norm-wise gap of all gradients as
    one vector."""
    from mxnet_tpu_torch.executor import GraphProgram
    from mxnet_tpu_torch.models import resnet
    kw = dict(kw, num_classes=10)
    shapes = conv_net_shapes(kw, batch, "NCHW")
    net = resnet.get_symbol(**kw)
    tr = ShardedTrainer(net, device="cpu")
    params, _, aux = tr.init_state(shapes, seed=3)
    rs = np.random.RandomState(seed)
    feed = {"data": rs.randn(*shapes["data"]).astype(np.float32),
            "softmax_label": rs.randint(0, 10, batch).astype(np.float32)}
    prog = GraphProgram(net)
    res = {}
    for d in ("cuda", "cpu"):
        leaves = [p.detach().to(d).requires_grad_() for p in params]
        m = dict(zip(tr.param_names, leaves),
                 **{k: torch.from_numpy(v).to(d) for k, v in feed.items()})
        outs, new_aux = prog.evaluate([m[n] for n in prog.arg_names],
                                      [a.to(d) for a in aux], train=True)
        grads = torch.autograd.grad(sum(o.sum() for o in outs), leaves,
                                    allow_unused=True)     # fixed gammas
        res[d] = ([o.detach().cpu() for o in outs + new_aux],
                  torch.cat([(torch.zeros_like(p) if g is None else g)
                             .detach().cpu().reshape(-1)
                             for p, g in zip(leaves, grads)]))
    fwd = max(((a - b).abs().max() / b.abs().max().clamp(min=1)).item()
              for a, b in zip(res["cuda"][0], res["cpu"][0]))
    gap = ((res["cuda"][1] - res["cpu"][1]).norm()
           / res["cpu"][1].norm()).item()
    return fwd, gap


# phase 18's small ResNets: (label, get_symbol kwargs, batch)
CIFAR20 = ("cifar ResNet-20 12x12", dict(num_layers=20,
                                         image_shape="3,12,12"), 4)
IMAGENET18 = ("imagenet ResNet-18 64x64", dict(num_layers=18,
                                               image_shape="3,64,64"), 2)
BOTTLENECK50 = ("bottleneck ResNet-50 40x40", dict(num_layers=50,
                                                   image_shape="3,40,40"), 2)


def phase_convnet_parity(torch, mx, ShardedTrainer, convert, card):
    """Two ShardedTrainer steps of small ResNets on the card and on the
    CPU from one state, NCHW and NHWC: the cifar branch (depth 20) held
    per tensor, the imagenet branch's stem and padded max pool (depth
    18) norm-wise; the bottleneck units (depth 50) by one training
    forward and gradient; then three Module.fit batches of the cifar
    ResNet, whose BatchNorm statistics go through the Module's aux
    path.  ``tools/convnet_gaps.py`` measures the same gaps over seeds
    and sizes: where a ReLU or max-pool input lies within float32
    rounding of a tie, the two devices may take different branches, and
    the imagenet stem's ``bn0_gamma`` gradient is ill-conditioned
    (PERF.md §6)."""
    for (label, kw, batch), strict in ((CIFAR20, True), (IMAGENET18, False)):
        for layout in ("NCHW", "NHWC"):
            per_tensor, norms, (loss_c, loss_h) = resnet_two_steps(
                torch, ShardedTrainer, convert, kw, batch, layout)
            beyond = sum(r > 1e-3 for r, _, _ in per_tensor)
            log("%s %s batch %d, 2 steps card vs cpu: worst tensors %s; "
                "norm-wise params %.3g, moms %.3g, aux %.3g; %d of %d "
                "tensors beyond 1e-3 of their largest change; loss %.6f vs "
                "%.6f [%s]"
                % (label, layout, batch, ", ".join(
                    "%s %s %.3g" % (p, n, r) for r, p, n in per_tensor[:3]),
                   norms["params"], norms["moms"], norms["aux"], beyond,
                   len(per_tensor), loss_c, loss_h, card))
            check(abs(loss_c - loss_h) <= 1e-4 * abs(loss_h),
                  "%s %s: loss differs" % (label, layout))
            if strict:
                check(per_tensor[0][0] <= 1e-3,
                      "%s %s: %s %s on the card differs from the CPU by "
                      "%.3g of its largest change (tolerance 1e-3)"
                      % (label, layout, per_tensor[0][1], per_tensor[0][2],
                         per_tensor[0][0]))
            else:
                check(max(norms.values()) <= 1e-2,
                      "%s %s: norm-wise gaps %s (tolerance 1e-2)"
                      % (label, layout, norms))
    label, kw, batch = BOTTLENECK50
    fwd, gap = resnet_fwd_grad(torch, ShardedTrainer, kw, batch)
    log("%s batch %d, training forward and gradient card vs cpu: outputs "
        "and new aux within %.3g (tolerance 1e-4), gradients norm-wise "
        "%.3g apart (tolerance 5e-2) [%s]" % (label, batch, fwd, gap, card))
    check(fwd <= 1e-4 and gap <= 5e-2, "%s card vs cpu" % label)
    # Module.fit: three batches of the cifar ResNet-20
    from mxnet_tpu_torch.models import resnet
    kw = dict(num_classes=10, num_layers=20, image_shape="3,12,12")
    rs = np.random.RandomState(5)
    X = rs.randn(24, 3, 12, 12).astype(np.float32)
    y = rs.randint(0, 10, 24).astype(np.float32)
    net = resnet.get_symbol(**kw)
    torch.manual_seed(0)
    mx.random.seed(0)             # the initializers' host stream
    init = mx.mod.Module(net, context=mx.cpu())
    it = mx.io.NDArrayIter(X, y, batch_size=8)
    init.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    init.init_params(initializer=mx.init.Xavier())
    args, auxs = ({k: v.asnumpy() for k, v in part.items()}
                  for part in init.get_params())
    got = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        mod = mx.mod.Module(net, context=ctx)
        a, x = convert.module_params_from_numpy(args, auxs)
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), arg_params=a,
                aux_params=x, optimizer="sgd", num_epoch=1,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-4})
        ap, xp = mod.get_params()
        got[ctx.device_type] = ({k: v.asnumpy() for k, v in ap.items()},
                                {k: v.asnumpy() for k, v in xp.items()})
    worst = 0.0
    for part, s0 in zip(range(2), (args, auxs)):
        for name, want in got["cpu"][part].items():
            change = float(np.abs(want - s0[name]).max())
            err = float(np.abs(got["gpu"][part][name] - want).max())
            check(change > 0 and err <= 1e-3 * change,
                  "Module.fit %s on the card differs from the CPU by %.3g, "
                  "its largest change is %.3g" % (name, err, change))
            worst = max(worst, err / change)
    log("Module.fit cifar ResNet-20 12x12, 3 batches of 8, card vs cpu: %d "
        "params and %d aux states within %.3g of each tensor's largest "
        "change (tolerance 1e-3) [%s]"
        % (len(got["cpu"][0]), len(got["cpu"][1]), worst, card))


def train_ce(torch, tr, params, aux, data, label):
    """Mean -log p[label] of a training-mode forward (batch statistics,
    as the step sees them; the moving statistics are not moved)."""
    prog = tr.prog
    args = [None] * len(prog.arg_names)
    for i, p in zip(tr.param_idx, params):
        args[i] = p
    args[tr.input_idx["data"]] = data
    args[tr.input_idx["softmax_label"]] = label
    with torch.no_grad():
        probs = prog.evaluate(args, aux, train=True)[0][0]
        picked = probs.gather(1, label.long()[:, None]).double()
        return float(-picked.clamp(min=1e-30).log().mean())


# The training check of the ResNet-50 phases (19, 22): the timed loops
# run bench.py's lr 0.1, where the cross-entropy of the repeated batch
# spikes (step 1 throws it from ~3.7 to 15-29, later spikes placed by
# cuDNN's algorithm choice, which differs in every process), so where
# that loop ends says nothing of the port.  The check runs a fresh
# trainer of the same model, batch, momentum and wd at RESNET_CHECK's lr
# for its steps and asks the cross-entropy to fall by its margin.  lr and
# margin were chosen with tools/resnet_bf16_probe.py --check over fresh
# processes in f32 and bf16, which also shows the check failing with the
# gradient's sign flipped and at lr 0 (PERF.md).
RESNET_CHECK = dict(lr=0.01, steps=8, margin=1.0)


def resnet_loss_check(torch, ShardedTrainer, sgd_step_fn, net, shapes,
                      inputs, mode, param_dtype=None, lr=None, tamper=None,
                      steps=None):
    """A fresh ResNet-50 trainer (momentum 0.9, wd 1e-4, init seed 0) at
    ``lr`` (default RESNET_CHECK's) for RESNET_CHECK's steps through
    ``mode`` (``step``, ``sgd_step_fn`` or ``build_step_auto_layout``) on
    the repeated batch ``inputs``; ``tamper(trainer)`` may change the
    trainer first (the probe breaks its update), ``steps`` the number of
    steps.  Returns (passed, the cross-entropy before the first step,
    after each step)."""
    lr = RESNET_CHECK["lr"] if lr is None else lr
    steps = RESNET_CHECK["steps"] if steps is None else steps
    tr = ShardedTrainer(net, lr=lr, momentum=0.9, wd=1e-4,
                        param_dtype=param_dtype)
    if tamper is not None:
        tamper(tr)
    state = tr.init_state(shapes, seed=0)
    if mode == "build_step_auto_layout":
        step, *state = tr.build_step_auto_layout(*state, shapes)
    elif mode == "sgd_step_fn":
        step = sgd_step_fn(tr)
    keys, guard = tr._keys(), tr._guard_arrays()
    p, m, x = state
    data, label = inputs["data"], inputs["softmax_label"]
    ce0 = train_ce(torch, tr, p, x, data, label)
    ces = []
    for _ in range(steps):
        if mode == "step":
            p, m, x, _loss = tr.step(p, m, x, inputs)
        else:
            p, m, x, _loss, _ok, guard = step(p, m, x, inputs, keys, guard)
        ces.append(train_ce(torch, tr, p, x, data, label))
    passed = bool(np.isfinite(ce0) and np.all(np.isfinite(ces))
                  and ces[-1] <= ce0 - RESNET_CHECK["margin"])
    del p, m, x, tr
    return passed, ce0, ces


# device kernel name fragments -> group of the ResNet step's time
CONV_GROUPS = (("conv weight-gradient", ("wgrad",)),
               ("conv data-gradient", ("dgrad",)),
               ("conv forward", ("fprop", "conv", "implicit_gemm",
                                 "xmma")),
               ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw",
                               "welford", "cudnn::bn")),
               ("SGD", ("multi_tensor", "foreach")),
               ("matmul (FC)", ("gemm",)),
               ("pooling", ("pool",)),
               ("reductions", ("reduce",)),
               ("elementwise", ("elementwise", "copy", "fill", "where",
                                "relu", "threshold")))


def phase_resnet50(torch, kernels, ShardedTrainer, card):
    """ResNet-50 training at bench.py's configuration, NCHW then NHWC;
    returns the port kernels launched (none: the path runs on cuDNN and
    cuBLAS)."""
    from mxnet_tpu_torch.models import resnet
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cudnn.benchmark = True
    kernels.reset_launches()
    for layout, timed_n in (("NCHW", 10), ("NHWC", 5)):
        kw = dict(RESNET50, layout=layout)
        shapes = conv_net_shapes(kw, RESNET_BATCH, layout)
        net = resnet.get_symbol(**kw)
        tr = ShardedTrainer(net, lr=0.1, momentum=0.9, wd=1e-4)
        t0 = time.perf_counter()
        params, mom, aux = tr.init_state(shapes, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        data = torch.randn(shapes["data"], generator=gen, device="cuda")
        label = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen,
                              device="cuda").float()
        batch = {"data": data, "softmax_label": label}
        log("ResNet-50 %s init_state: %d tensors, %.2f M parameters, %d aux "
            "states, %.1f s" % (layout, len(params),
                                sum(p.numel() for p in params) / 1e6,
                                len(aux), time.perf_counter() - t0))
        ce0 = train_ce(torch, tr, params, aux, data, label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2 + timed_n):
            t0 = time.perf_counter()
            params, mom, aux, loss = tr.step(params, mom, aux, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, mom, aux, loss = tr.step(params, mom, aux, batch)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        ce1 = train_ce(torch, tr, params, aux, data, label)
        timed = times[2:]
        med = statistics.median(timed)
        flops = train_flops(net, shapes)
        log("ResNet-50 %s %s batch %d f32 (cudnn.benchmark on, TF32 off): "
            "warm-up %s ms; timed %s ms; median %.2f ms (spread %.2f-%.2f) "
            "= %.1f images/s [%s]"
            % (layout, "x".join(kw["image_shape"].split(",")[1:]),
               RESNET_BATCH, ", ".join("%.1f" % t for t in times[:2]),
               ", ".join("%.2f" % t for t in timed), med, min(timed),
               max(timed), RESNET_BATCH / med * 1e3, card))
        by_kernel = device_by_kernel(prof)
        if by_kernel:
            busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
            groups = {g: 0.0 for g, _ in CONV_GROUPS}
            groups["other"] = 0.0
            for key, (us, _cnt) in by_kernel.items():
                low = key.lower()
                group = next((g for g, frags in CONV_GROUPS
                              if any(f in low for f in frags)), "other")
                groups[group] += us / 1e3
            log("  device time of one step by kernel (torch.profiler) [%s]:"
                % card)
            for key, (us, cnt) in sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1][0])[:14]:
                log("  %9.1f us  x%-4d %s" % (us, cnt, key[:100]))
            log("  by group: %s" % ", ".join(
                "%s %.2f ms" % kv for kv in sorted(groups.items(),
                                                   key=lambda kv: -kv[1])))
            # the profiler slows the host: the unprofiled median is the
            # other denominator of the same busy time
            log("  device busy %.2f ms of the profiled step's %.2f ms: idle "
                "share %.3f; of the unprofiled median %.2f ms: %.3f"
                % (busy_ms, prof_ms, 1 - busy_ms / prof_ms, med,
                   1 - busy_ms / med))
        else:
            log("  device busy: not measured (the profiler saw no device "
                "time)")
        log("  peak memory allocated %.2f GB; FLOPs per step = 2 x 3 x "
            "multiply-adds of every Convolution and FullyConnected = %.4f "
            "TFLOP -> %.2f TFLOP/s = %.3f of the 67 TFLOP/s f32 peak (%.2f "
            "ms at peak); cross-entropy of the repeated batch before %.4f, "
            "after %d steps %.4f [%s]"
            % (peak / 1e9, flops / 1e12, flops / med / 1e9,
               flops / (med / 1e3) / F32_FLOPS_S, flops / F32_FLOPS_S * 1e3,
               ce0, len(times) + 1, ce1, card))
        check(tr.skipped_steps == 0, "a ResNet-50 step was skipped")
        del params, mom, aux, tr
        torch.cuda.empty_cache()
        ok, c0, ces = resnet_loss_check(torch, ShardedTrainer, None, net,
                                        shapes, batch, "step")
        log("  training check: a fresh trainer at lr %g, %d steps: "
            "cross-entropy %.4f -> %s; must fall by %g: %s [%s]"
            % (RESNET_CHECK["lr"], RESNET_CHECK["steps"], c0,
               ", ".join("%.3f" % c for c in ces), RESNET_CHECK["margin"],
               "passed" if ok else "FAILED", card))
        check(ok, "ResNet-50 %s f32: the training check's cross-entropy "
              "did not fall by %g (%.4f -> %.4f)"
              % (layout, RESNET_CHECK["margin"], c0, ces[-1]))
        check(torch.backends.cudnn.allow_tf32 is False,
              "cuDNN's TF32 is on after the ResNet step")
        del batch, data
        torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    got = dict(kernels.LAUNCHES)
    check(not any(got.values()), "the ResNet path launched a hand-written "
          "kernel: %s" % got)
    log("hand-written kernel launches on the ResNet path: none (%s)" % got)
    return got


def b10_push(torch, dtype, seed, pushes=None, misalign=True):
    """Grads and residuals of every key of a push (ResNet-50's by
    default) in ``dtype``, three of
    four views misaligned by 1-3 elements when ``misalign``; the
    threshold's edge values (+-1 ulp of f32(0.5), NaN, +-inf) at the front
    of every eighth residual, with a zero gradient."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t32 = np.float32(0.5)
    edges = torch.tensor([t32, np.nextafter(t32, np.float32(1)),
                          np.nextafter(t32, np.float32(0)), -t32, 0.0,
                          np.nan, np.inf, -np.inf], device="cuda")
    gs, rs = [], []
    pushes = resnet50_pushes() if pushes is None else pushes
    for i, shape in enumerate(s for s, k in pushes for _ in range(k)):
        n = int(np.prod(shape))
        a, b = (i % 4, (i + 1) % 4) if misalign else (0, 0)
        g = (torch.randn(n + a, generator=gen, device="cuda")
             * 0.5)[a:].to(dtype)
        r = (torch.randn(n + b, generator=gen, device="cuda")
             * 0.2)[b:].to(dtype)
        if i % 8 == 0:
            m = min(n, 8)
            g[:m] = 0
            r[:m] = edges[:m].to(dtype)
        gs.append(g.view(shape))
        rs.append(r.view(shape))
    return gs, rs


def b10_equal(torch, kernels, gs, rs):
    """The grouped kernel over ``gs``/``rs`` (residuals updated in place)
    against its plain version, exactly; returns (qs, launches by name,
    max_abs_err)."""
    want_q, want_r = kernels.two_bit_compress_many_plain(gs, rs, 0.5)
    before = dict(kernels.LAUNCHES)
    qs = kernels.two_bit_compress_many(gs, rs, 0.5)
    torch.cuda.synchronize()
    err, same = 0.0, True
    for a, b in zip(qs + rs, want_q + want_r):
        nan = torch.isnan(b)
        same &= a.dtype == b.dtype and torch.equal(torch.isnan(a), nan) \
            and torch.equal(a[~nan], b[~nan])
        if a.numel():
            err = max(err, (a[~nan].float() - b[~nan].float()).abs().max()
                      .item())
    check(same, "B10 differs from its plain version")
    return qs, {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}, err


def phase_two_bit_dtypes(torch, kernels, timer, card):
    """B10 (a): the two-bit kernel in f16, bf16 and f64 against its plain
    version, exactly: ResNet-50's push (157 keys) in each dtype, misaligned
    views and edge values included, one launch per dtype; one push of
    mixed dtypes (one launch each); a strided gradient.  Timed: the f16
    push (the Module.fit path) and its one-segment shapes."""
    rows = []
    for dtype in (torch.float16, torch.bfloat16, torch.float64):
        gs, rs = b10_push(torch, dtype, 7)
        _qs, launched, err = b10_equal(torch, kernels, gs, rs)
        name = "two_bit_compress" + kernels._TWO_BIT_DTYPES[dtype]
        check(launched == {name: 1}, "B10 %s launches: %s" % (dtype,
                                                              launched))
        log("B10 %s over ResNet-50's push (157 keys, misaligned views, edge "
            "values): equal to the plain version (tolerance 0), launches %s"
            % (str(dtype)[6:], launched))
        del gs, rs
    mixed = [b10_push(torch, dt, 8 + i, pushes=[((4099,), 3), ((768, 5), 2)])
             for i, dt in enumerate((torch.float32, torch.float16,
                                     torch.bfloat16, torch.float64))]
    _qs, launched, _err = b10_equal(torch, kernels,
                                    sum((g for g, _ in mixed), []),
                                    sum((r for _, r in mixed), []))
    check(launched == {"two_bit_compress" + s: 1
                       for s in kernels._TWO_BIT_DTYPES.values()},
          "a push of mixed dtypes launched %s" % launched)
    g = torch.randn(300, 200, device="cuda").half().t()
    r = torch.zeros(300, 400, device="cuda").half()[:, ::2].t()
    q0, r0 = kernels.two_bit_compress_plain(g, r, 0.5)
    q, _ = kernels.two_bit_compress(g, r, 0.5)
    check(torch.equal(q, q0) and torch.equal(r, r0), "B10 on a strided "
          "gradient and residual differs from its plain version")
    log("B10 over a push of f32, f16, bf16 and f64 keys: equal, launches %s;"
        " a transposed f16 gradient with a strided residual: equal" %
        launched)
    gs, rs = b10_push(torch, torch.float16, 9, misalign=False)
    qs, launched, err = b10_equal(torch, kernels, gs, rs)
    n = sum(g.numel() for g in gs)
    b, by = bound_ms(8 * n, 2 * n)
    rows.append({
        "name": "two_bit_compress_f16", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/two_bit.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:121",
        "shape": "ResNet-50's push: %d keys, %d elements f16, threshold "
                 "0.5, grouped" % (len(gs), n),
        "launches_per_step": launched.get("two_bit_compress_f16"),
        "max_abs_err": err,
        "ms": timer(lambda: kernels.two_bit_compress_many(gs, rs, 0.5)),
        "plain_ms": timer(lambda: kernels.two_bit_compress_many_plain(
            gs, rs, 0.5)),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "library_call": "none: no single PyTorch call computes q and the "
                        "new residual"})
    del gs, rs, qs
    for shape in ((2048, 512, 1, 1), (256, 256, 3, 3), (1000, 2048),
                  (64, 3, 7, 7), (256,)):
        gs, rs = b10_push(torch, torch.float16, 10, pushes=[(shape, 1)],
                          misalign=False)
        n = gs[0].numel()
        b, by = bound_ms(8 * n, 2 * n)
        log("  B10 f16 one segment %-18s ms=%.4f plain_ms=%.4f "
            "bound_ms=%.4f (%s) [%s]" % (
                shape, timer(lambda: kernels.two_bit_compress(
                    gs[0], rs[0], 0.5)),
                timer(lambda: kernels.two_bit_compress_plain(
                    gs[0], rs[0], 0.5)), b, by, card))
    r = rows[0]
    log("  %-22s %-66s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) [%s]"
        % (r["name"], r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
           r["bound_by"], card))
    return rows


# ---------------------------------------------------------------------------
# float16 mixed precision through Module.fit (phase 24): ResNet-50 built
# with dtype="float16", multi-precision SGD, a 2-bit KVStore("device")
# (B10 on the f16 gradients), as example/image_classification/
# train_imagenet.py --benchmark 1 runs it
# ---------------------------------------------------------------------------

# train_imagenet.py's defaults: lr 0.1, factor 0.1 at epochs 30, 60, 80
# of ImageNet's 1,281,167 images at batch 32
IMAGENET_EPOCH = 1281167 // RESNET_BATCH
# the Module path's training check: a fresh Module on one repeated batch
# for its epochs (one step each) at its lr; the cross-entropy that the
# metric reads before the last update must lie its margin below the
# first's.  Chosen with tools/resnet_bf16_probe.py --check (PERF.md).
MODULE_CHECK = dict(lr=0.1, epochs=8, margin=1.0)


def f16_module(mx, net, X, Y, lr, epochs, batch=RESNET_BATCH, sched=None,
               sign=1.0, on_batch=None, compression=True, cpu=False,
               shuffle=False, start=None):
    """``Module.fit`` of ``net`` over (X, Y) as train_imagenet.py runs it:
    SGD with momentum 0.9, wd 1e-4, ``multi_precision``, ``sched``, Xavier
    (gaussian, in, 2) drawn after ``mx.random.seed(0)``, a 2-bit
    KVStore("device") at threshold 0.5 (``compression``), metrics
    Accuracy, CrossEntropy and top-5 accuracy.  ``sign`` -1 flips the
    gradient in the update (``rescale_grad``); ``cpu`` runs it all on
    the CPU; ``start`` (a dict) receives the initial parameters as host
    tensors by name.  Returns the Module."""
    import torch
    ctx = mx.cpu() if cpu else None
    mod = mx.mod.Module(net, context=ctx, compression_params={
        "type": "2bit", "threshold": 0.5} if compression else None)
    params = {"learning_rate": lr, "momentum": 0.9, "wd": 1e-4,
              "multi_precision": True, "rescale_grad": sign / batch}
    if sched is not None:
        params["lr_scheduler"] = sched
    it = mx.io.NDArrayIter(X, Y, batch_size=batch, shuffle=shuffle,
                           label_name="softmax_label")
    init = mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                          magnitude=2)
    torch.manual_seed(0)
    mx.random.seed(0)             # the initializers' host stream
    if start is not None:      # initialise before fit to read the start
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        mod.init_params(initializer=init)
        args, auxs = mod.get_params()
        start.update({k: v._handle.float().cpu() for k, v in
                      list(args.items()) + list(auxs.items())})
    mod.fit(it, kvstore=mx.kv.create("device", device="cpu" if cpu else None),
            optimizer="sgd", optimizer_params=params, initializer=init,
            eval_metric=[mx.metric.Accuracy(), mx.metric.CrossEntropy(),
                         mx.metric.TopKAccuracy(top_k=5)],
            batch_end_callback=on_batch, num_epoch=epochs)
    return mod


def module_loss_check(torch, mx, net, X, Y, lr=None, sign=1.0, epochs=None):
    """The Module path's training check on one repeated batch (X, Y):
    (passed, the cross-entropy the metric read in each epoch, before that
    epoch's update).  ``sign`` -1 flips the gradient in the update (the
    probe's broken update)."""
    lr = MODULE_CHECK["lr"] if lr is None else lr
    ces = []
    mod = f16_module(mx, net, X, Y, lr, epochs or MODULE_CHECK["epochs"],
                     sign=sign,
                     on_batch=lambda p: ces.append(p.eval_metric.get()[1][1]))
    del mod
    torch.cuda.empty_cache()
    passed = bool(np.all(np.isfinite(ces))
                  and ces[-1] <= ces[0] - MODULE_CHECK["margin"])
    return passed, ces


def phase_module_f16(torch, mx, kernels, kv_mod, card):
    """(b) float16 through Module.fit: the cifar ResNet-20 (28x28) card vs
    CPU over two batches (multi-precision SGD through the store, no
    compression: both sides quantize by their own f16 gradients), then
    ResNet-50 f16 at train_imagenet.py's benchmark configuration: 128
    seeded images, 4 batches an epoch, shuffled, MultiFactorScheduler,
    2-bit store; 4 epochs (1 warm-up step, 10 timed, 1 profiled, 4 that
    count the fired values), B10 launches per step, the fired share, host
    ms in update(), peak memory;
    then the training check (MODULE_CHECK)."""
    from mxnet_tpu_torch.models import resnet
    small = dict(num_classes=10, num_layers=20, image_shape="3,28,28",
                 dtype="float16")
    rs = np.random.RandomState(5)
    Xs = rs.randn(8, 3, 28, 28).astype(np.float32)
    Ys = rs.randint(0, 10, 8).astype(np.float32)
    got, s0 = {}, {}
    for tag, cpu, dt in (("card", False, "float16"), ("cpu", True,
                                                      "float16"),
                         ("f32", True, "float32")):
        mod = f16_module(mx, resnet.get_symbol(**dict(small, dtype=dt)),
                         Xs, Ys, 0.1, 1, batch=4, compression=False,
                         cpu=cpu, start=s0 if tag == "cpu" else None)
        args, auxs = mod.get_params()
        got[tag] = {k: v._handle.float().cpu() for k, v in
                    list(args.items()) + list(auxs.items())}
        if tag == "card":
            states = mod._kvstore._updater.states
            check(all(isinstance(st, tuple) and st[0].dtype == np.float32
                      for st in states.values()),
                  "a float16 weight has no f32 master in the store")
        del mod
    names = sorted(got["card"])
    own_gap_check(torch, names, [s0[n] for n in names],
                  [got["card"][n] for n in names],
                  [got["cpu"][n] for n in names],
                  [got["f32"][n] for n in names],
                  "cifar ResNet-20 28x28 f16 Module.fit, 2 batches", card,
                  "float16")
    torch.backends.cudnn.benchmark = True
    kw = dict(RESNET50, layout="NCHW", dtype="float16")
    net = resnet.get_symbol(**kw)
    rs = np.random.RandomState(0)
    n = 4 * RESNET_BATCH
    X = rs.rand(n, 3, 224, 224).astype(np.float32)
    Y = rs.randint(0, 1000, n).astype(np.float32)
    steps = [e * IMAGENET_EPOCH for e in (30, 60, 80)]
    sched = mx.lr_scheduler.MultiFactorScheduler(steps, 0.1)
    sched.base_lr = 0.1
    warm, timed, epochs = 1, 10, 4
    prof_step = warm + timed + 1
    ev, launches, ces, update_ms, fired = [], [], [], [], []
    counting = {}
    prof = {}
    cls = kv_mod._TwoBitCompressor
    orig = cls.compress_many

    def count(self, keys, grads):
        qs = orig(self, keys, grads)
        fired.append(sum(int(torch.count_nonzero(q)) for q in qs))
        counting["n"] = sum(q.numel() for q in qs)
        return qs

    from torch.profiler import ProfilerActivity, profile

    def on_batch(p):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)
        launches.append(kernels.LAUNCHES["two_bit_compress_f16"])
        ces.append(p.eval_metric.get()[1][1])
        if len(ev) == prof_step - 1:
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif len(ev) == prof_step:
            torch.cuda.synchronize()
            prof["wall"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].__exit__(None, None, None)
            cls.compress_many = count

    orig_update = mx.mod.Module.update

    def timed_update(self):
        t0 = time.perf_counter()
        orig_update(self)
        update_ms.append((time.perf_counter() - t0) * 1e3)

    mx.mod.Module.update = timed_update
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_fit = time.perf_counter()
    try:
        mod = f16_module(mx, net, X, Y, 0.1, epochs, sched=sched,
                         on_batch=on_batch, shuffle=True)
    finally:
        mx.mod.Module.update = orig_update
        cls.compress_many = orig
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    peak = torch.cuda.max_memory_allocated()
    counts = dict(kernels.LAUNCHES)
    n_steps = len(ev)
    n_keys = len(mod._exec_group.param_names)
    args, _ = mod.get_params()
    dts = sorted({str(a._handle.dtype)[6:] for a in args.values()})
    check(n_steps == 4 * epochs, "fit ran %d steps" % n_steps)
    check(counts["two_bit_compress_f16"] == n_steps
          and counts["two_bit_compress"] == 0,
          "B10 f16 launched %d times over %d steps (f32: %d), want one "
          "per step" % (counts["two_bit_compress_f16"], n_steps,
                        counts["two_bit_compress"]))
    states = mod._kvstore._updater.states
    check(len(states) == n_keys and all(
        isinstance(st, tuple) and st[0]._handle.dtype == torch.float32
        and st[1]._handle.dtype == torch.float32 for st in states.values()),
        "the store's states are not (weight32, mom) in f32")
    ms = [a.elapsed_time(b) for a, b in zip(ev[warm - 1:warm + timed - 1],
                                            ev[warm:warm + timed])]
    med = statistics.median(ms)
    upd = update_ms[warm:warm + timed]
    log("ResNet-50 NCHW 224x224 batch %d float16 (params %s) through "
        "Module.fit: multi-precision SGD (lr 0.1, MultiFactorScheduler at "
        "%s, momentum 0.9, wd 1e-4), KVStore('device') with 2-bit "
        "compression (threshold 0.5), %d keys; %d steps in %.1f s "
        "(cudnn.benchmark on) [%s]"
        % (RESNET_BATCH, "/".join(dts), steps, n_keys, n_steps, fit_s,
           card))
    log("  step ms (CUDA events at batch end, steps %d-%d): %s; median "
        "%.2f (spread %.2f-%.2f) = %.1f images/s; host ms in update() "
        "%s (median %.2f) [%s]"
        % (warm + 1, warm + timed, ", ".join("%.2f" % x for x in ms), med,
           min(ms), max(ms), RESNET_BATCH / med * 1e3,
           ", ".join("%.1f" % x for x in upd), statistics.median(upd),
           card))
    by_kernel = device_by_kernel(prof["p"])
    busy = sum(us for us, _ in by_kernel.values()) / 1e3
    b10 = sum(us for k, (us, _) in by_kernel.items()
              if "two_bit" in k) / 1e3
    groups = {g: 0.0 for g, _ in CONV_GROUPS}
    groups["other"] = 0.0
    for key, (us, _cnt) in by_kernel.items():
        low = key.lower()
        g = next((g for g, frags in CONV_GROUPS
                  if any(f in low for f in frags)), "other")
        groups[g] += us / 1e3
    log("  profiled step %d: device busy %.2f ms of %.2f ms, idle share "
        "%.3f (of the unprofiled median %.2f: %.3f); B10 %.4f ms in %d "
        "launch(es); by group: %s [%s]"
        % (prof_step, busy, prof["wall"], 1 - busy / prof["wall"], med,
           1 - busy / med, b10, launches[prof_step - 1]
           - launches[prof_step - 2], ", ".join(
               "%s %.2f ms" % kv for kv in sorted(groups.items(),
                                                   key=lambda kv: -kv[1])),
           card))
    share = [f / counting["n"] for f in fired]
    log("  B10 launches per step %s; fired share (q != 0) in the steps "
        "after the profiled one: %s; peak memory %.2f GB; cross-entropy "
        "read by the metric per step: %s [%s]"
        % (sorted({b - a for a, b in zip([0] + launches, launches)}),
           ", ".join("%.5f" % x for x in share), peak / 1e9,
           ", ".join("%.3f" % c for c in ces), card))
    check(all(np.isfinite(ces)), "a non-finite cross-entropy in the f16 "
          "Module.fit run")
    del mod
    torch.cuda.empty_cache()
    ok, cks = module_loss_check(torch, mx, net, X[:RESNET_BATCH],
                                Y[:RESNET_BATCH])
    log("  training check: a fresh Module on one repeated batch at lr %g, "
        "%d steps: cross-entropy %s; must fall by %g: %s [%s]"
        % (MODULE_CHECK["lr"], MODULE_CHECK["epochs"],
           ", ".join("%.3f" % c for c in cks), MODULE_CHECK["margin"],
           "passed" if ok else "FAILED", card))
    check(ok, "the f16 ResNet-50 Module.fit check: the cross-entropy did "
          "not fall by %g (%s)" % (MODULE_CHECK["margin"], cks))
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# bench.py's training configuration (phases 20-22): bf16 parameters
# through ShardedTrainer, the raw step (sgd_step_fn) and the auto-layout
# step (build_step_auto_layout), the LM on the bf16 flash kernels (B9)
# ---------------------------------------------------------------------------

BF16_FLOPS_S = 989e12         # H100 SXM dense bf16 on the tensor cores

# MMAs per product of 2·D flops per (q, k) pair in each B9 kernel, and
# their rate: bf16 MMAs, one where both operands are bf16 (q k^T, dO v^T,
# k q^T, v dO^T), two where one side is f32 (p v, ds k, p^T dO, ds^T q as
# bf16 hi + lo).
B9_MMAS = {"fwd": (1 + 2, BF16_FLOPS_S), "dq": (1 + 1 + 2, BF16_FLOPS_S),
           "dkv": (1 + 1 + 2 + 2, BF16_FLOPS_S)}
B9_MATH = {
    "fwd": "bf16 tiles, bf16 m16n8k16 mma.sync: 1 MMA for q k^T, 2 for "
           "p v (p as bf16 hi + lo)",
    "dq": "bf16 tiles, bf16 m16n8k16 mma.sync: 1 MMA each for q k^T and "
          "dO v^T, 2 for ds k (ds as bf16 hi + lo)",
    "dkv": "bf16 tiles, bf16 m16n8k16 mma.sync: 1 MMA each for k q^T and "
           "v dO^T, 2 each for p^T dO and ds^T q (hi + lo)"}


def b9_bound(B, Tq, Tk, H, D, causal, units, n_in, n_out, n_rows, mmas):
    """Bound of one B9 kernel: the bf16 (B, T, H, D) tensors read and
    written once (2 bytes an element) and ``n_rows`` f32 (B·H, T) rows
    (lse written by the forward; lse and delta read by dQ and dK/dV), against
    ``units`` x D flops per (q, k) pair that the mask keeps at the dense
    bf16 tensor rate (989 TFLOP/s); and the same work as the kernel does
    it, ``mmas = (count, rate)``: count MMAs of 2·D flops per pair at the
    rate of their type."""
    pairs = sum(min(Tk, q + 1) for q in range(Tq)) if causal else Tq * Tk
    flops = units * B * H * pairs * D
    nbytes = (n_in + n_out) * B * Tq * H * D * 2 + n_rows * B * H * Tq * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
    count, rate = mmas
    tc = max(t_bytes, count * 2 * B * H * pairs * D / rate) * 1e3
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", tc)


# Times of the earlier B9 design at the training shape, bf16 tiles
# widened to f32 on TF32 MMAs (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# §6): the kernels that the bf16 ones replaced, for the log beside this
# run's
B9_WIDENED_MS = {"flash_attention_fwd_bf16": "0.2443 ms",
                 "flash_attention_bwd_dq_bf16": "0.3883 ms",
                 "flash_attention_bwd_dkv_bf16": "0.4585 ms"}


def sdpa_backend(torch, q, k, v, causal):
    """The backend that PyTorch's dispatcher picks for
    ``scaled_dot_product_attention`` on these (B, H, T, D) inputs
    (``torch._fused_sdp_choice``), by name."""
    from torch.nn.attention import SDPBackend
    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    i = int(torch._fused_sdp_choice(q, k, v, is_causal=causal))
    return names.get(i, str(i))


def lowp_close(torch, got, want, base):
    """Largest error of ``got`` over its tolerance against ``want`` (both
    bf16 or both f16): one step of each element in ``want``'s dtype (2^-7
    of its magnitude in bf16, 2^-10 in f16) plus ``base`` x max(1,
    max|want|), the f32 kernels' own tolerance; and the largest absolute
    error.  Elements that are inf or NaN in ``want`` must be the same in
    ``got`` and count as exact."""
    step = 2.0 ** -10 if want.dtype == torch.float16 else 2.0 ** -7
    got, want = got.float(), want.float()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    err = torch.where(same, torch.zeros(()), (got - want).abs())
    fin = want[torch.isfinite(want)]
    tol = step * want.abs() + base * max(
        1.0, fin.abs().max().item() if fin.numel() else 1.0)
    ratio = torch.where(same, torch.zeros(()), err / tol)
    return ratio.max().item(), err.max().item()


def phase_flash_16(torch, kernels, F, timer, card, kind):
    """B9 in ``kind`` (bf16 or f16) against its plain versions: at the
    LM's training shape (timed, with bounds and SDPA in the same dtype as
    the yardstick) and at ragged shapes (T not a multiple of 64; D 32 and
    128); in f16 also with dO at a loss scale's size (its largest |dO|
    6e4)."""
    dev = torch.device("cuda")
    dt = {"bf16": torch.bfloat16, "f16": torch.float16}[kind]
    sfx = "_" + kind
    H, D = TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"]
    rows = []
    cases = [(8, 1024, H, D, True, True), (2, 1000, 3, 32, True, False),
             (2, 777, 2, 128, True, False), (2, 520, 4, 64, False, False)]
    if kind == "f16":
        cases.append((2, 256, 4, 64, True, "loss-scale"))
    for B, T, Hc, Dc, causal, timed in cases:
        rs = np.random.RandomState(T + Dc)
        q, k, v, do = (torch.from_numpy(rs.randn(B, T, Hc, Dc).astype(
            np.float32)).to(dev) for _ in range(4))
        if timed == "loss-scale":
            q, k, do, timed = q * 2.5, k * 2.5, do * (6e4 / do.abs().max()
                                                      .item()), False
        q, k, v, do = (x.to(dt) for x in (q, k, v, do))
        tag = "B%d T%d H%d D%d %s %s%s" % (
            B, T, Hc, Dc, kind, "causal" if causal else "full",
            "" if do.abs().max().item() < 100 else ", max|dO| %.0f"
            % do.abs().max().item())
        before = dict(kernels.LAUNCHES)
        out, lse = kernels.flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = kernels.flash_attention_fwd_plain(q, k, v, causal)
        delta = kernels.flash_delta(ref, do)
        dq = kernels.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta,
                                            causal)
        dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, ref_lse,
                                                 delta, causal)
        refs = kernels.flash_attention_bwd_plain(q, k, v, ref, ref_lse, do,
                                                 causal)
        torch.cuda.synchronize()
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            check(kernels.LAUNCHES[name + sfx] == before[name + sfx] + 1
                  and kernels.LAUNCHES[name] == before[name],
                  "%s: the %s kernel did not launch once" % (name, kind))
        check(out.dtype == dq.dtype == dk.dtype == dv.dtype == dt
              and lse.dtype == torch.float32, "B9 output dtypes")
        ratio = {"out": lowp_close(torch, out, ref, 1e-5)}
        lse_err = (lse - ref_lse).abs().max().item()
        ratio["lse"] = (lse_err / (1e-5 * max(1.0, ref_lse.abs().max()
                                              .item())), lse_err)
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            ratio[name] = lowp_close(torch, got, want, 1e-4)
        log("B9 %s: error/tolerance %s; max_abs_err %s (tolerance: one %s "
            "step of each element plus the f32 kernels' 1e-5 (out, lse) / "
            "1e-4 (dq, dk, dv) x max(1, max|ref|); the reference's own bf16 "
            "bar is rtol 0.1, atol 0.05) [%s]"
            % (tag, ", ".join("%s %.3g" % (n, r[0]) for n, r in ratio.items()),
               ", ".join("%s %.3g" % (n, r[1]) for n, r in ratio.items()),
               kind, card))
        check(all(r[0] <= 1.0 for r in ratio.values()),
              "B9 disagrees with its plain versions at %s" % tag)
        again = (kernels.flash_attention_fwd(q, k, v, causal)[0],
                 kernels.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta,
                                                causal)) + \
            kernels.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta,
                                            causal)
        check(all(torch.equal(a, b) for a, b in zip((out, dq, dk, dv),
                                                     again)),
              "two launches of B9 gave different bits at %s" % tag)
        if not timed:
            continue
        # yardstick: SDPA in bf16 on the (B, H, T, D) transposes, the
        # forward, its autograd backward alone (the forward done outside
        # the timer, the graph retained), and the two; timed only
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            torch.autograd.grad(o, (qt, kt, vt), dot)

        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
        check(lowp_close(torch, lib_out.transpose(1, 2), ref, 1e-3)[0] <= 2,
              "the SDPA yardstick computes another function")
        lib_fwd = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        lib_bwd = timer(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True))
        lib_both = timer(sdpa_fwd_bwd)
        del lib_out
        log("SDPA %s at %s: forward %.4f ms, backward alone %.4f ms, "
            "forward + backward %.4f ms; backend %s [%s]"
            % (kind, tag, lib_fwd, lib_bwd, lib_both,
               sdpa_backend(torch, qt, kt, vt, causal), card))
        src = "mxnet_tpu_torch/csrc/flash_attention.cu"
        shape = "q/k/v (B, T, H, D) = (%d, %d, %d, %d) %s, causal" % (
            B, T, Hc, Dc, kind)
        common = {"route": "cuda", "source": src}
        specs = [
            ("flash_attention_fwd" + sfx, ":250", 4, 3, 1, 1, "fwd",
             lambda: kernels.flash_attention_fwd(q, k, v, causal),
             lambda: kernels.flash_attention_fwd_plain(q, k, v, causal),
             max(ratio["out"][1], ratio["lse"][1]), lib_fwd,
             "F.scaled_dot_product_attention(is_causal=True) %s forward"
             % kind,
             ", with lse"),
            ("flash_attention_bwd_dq" + sfx, ":448", 6, 4, 1, 2, "dq",
             lambda: kernels.flash_attention_bwd_dq(q, k, v, do, ref_lse,
                                                    delta, causal),
             lambda: kernels.flash_attention_bwd_dq_plain(
                 q, k, v, do, ref_lse, delta, causal),
             ratio["dq"][1], lib_bwd,
             "the %s SDPA autograd backward alone (dQ, dK, dV together)"
             % kind, ", dO, lse, delta"),
            ("flash_attention_bwd_dkv" + sfx, ":468", 8, 4, 2, 2, "dkv",
             lambda: kernels.flash_attention_bwd_dkv(q, k, v, do, ref_lse,
                                                     delta, causal),
             lambda: kernels.flash_attention_bwd_dkv_plain(
                 q, k, v, do, ref_lse, delta, causal),
             max(ratio["dk"][1], ratio["dv"][1]), lib_bwd,
             "the %s SDPA autograd backward alone (dQ, dK, dV together)"
             % kind, ", dO, lse, delta")]
        for (name, site, units, n_in, n_out, n_rows, kind_, fn, plain, err,
             lib, call, extra) in specs:
            b, by, tc = b9_bound(B, T, T, Hc, Dc, causal, units, n_in,
                                 n_out, n_rows, B9_MMAS[kind_])
            rows.append(dict(common, **{
                "name": name, "replaces": "mxnet_tpu/ops/pallas_kernels.py"
                + site, "shape": shape + extra,
                "math": B9_MATH[kind_].replace("bf16", kind),
                "launches_per_step": TRAIN["num_layers"],
                "max_abs_err": err, "ms": timer(fn),
                "plain_ms": timer(plain), "bound_ms": b, "bound_by": by,
                "bound_tc_ms": tc, "library_ms": lib,
                "library_call": call, "library_fwd_bwd_ms": lib_both}))
        del qt, kt, vt
    for r in rows:
        log("  %-28s %-52s ms=%.4f (widened-f32 design: %s) plain_ms=%.4f "
            "bound_ms=%.4f (%s, %s 989 TFLOP/s) bound_tc_ms=%.4f "
            "library_ms=%.4f [%s]"
            % (r["name"], r["shape"], r["ms"],
               B9_WIDENED_MS.get(r["name"], "none"), r["plain_ms"],
               r["bound_ms"], r["bound_by"], kind, r["bound_tc_ms"],
               r["library_ms"], card))
    return rows


# one step of each 16-bit dtype, as the own-gap checks' floor
LOWP_STEP = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def own_gap_check(torch, names, start, got, want, exact, label, card,
                  dtype="bfloat16"):
    """Norm-wise, per tensor: ``|got - want| / |want - start|`` at most 3x
    the ``dtype`` rounding gap of ``want`` itself, ``|want - exact| /
    |exact - start|`` (``exact``: the same step in f32 from the same
    weights), and at least one step of ``dtype`` (bf16 2^-8, f16 2^-11):
    two independent roundings of one size stand about sqrt(2) of it
    apart.  Each argument is a list of host tensors in ``names`` order."""
    worst = (0.0, "")
    kind = {"bfloat16": "bf16", "float16": "f16"}[dtype]
    for n, s0, a, b, e in zip(names, start, got, want, exact):
        s0, a, b, e = (t.double() for t in (s0, a, b, e))
        gap = ((a - b).norm() / (b - s0).norm().clamp(min=1e-30)).item()
        own = ((b - e).norm() / (e - s0).norm().clamp(min=1e-30)).item()
        ratio = gap / max(own, LOWP_STEP[dtype])
        check(ratio <= 3.0, "%s: %s on the card stands %.3g from the CPU, "
              "3x the CPU's own %s gap %.3g is the limit"
              % (label, n, gap, kind, own))
        worst = max(worst, (ratio, n))
    log("%s card vs cpu: every tensor within %.3g of the CPU's own %s "
        "rounding gap (limit 3; the gap: the CPU's %s step against its "
        "f32 step from the same weights; worst: %s) [%s]"
        % (label, worst[0], kind, kind, worst[1], card))


def bf16_step_triplet(torch, make, shapes, batch, label, card,
                      dtype="bfloat16"):
    """One step of ``make(device, param_dtype)``'s trainer on the card in
    ``dtype`` (bf16 or f16), on the CPU in that dtype and on the CPU in
    f32 from the same weights; the card's state held to the CPU's by
    ``own_gap_check``."""
    tr = make("cpu", dtype)
    start = tr.init_state(shapes, seed=3)
    names = tr.param_names + tr.param_names + tr.prog.aux_names
    res = {}
    for tag, dev, pdt in (("card", "cuda", dtype),
                          ("cpu", "cpu", dtype),
                          ("f32", "cpu", None)):
        t = make(dev, pdt)
        p, m, x = (tuple((a.float() if pdt is None else a.clone()).to(dev)
                         for a in part) for part in start)
        p, m, x, loss = t.step(p, m, x, batch)
        check(t.skipped_steps == 0 and np.isfinite(float(loss)),
              "%s %s step was not finite" % (label, tag))
        res[tag] = [a.detach().float().cpu() for a in p + m + x]
    own_gap_check(torch, names, [a.float() for a in sum(start, ())],
                  res["card"], res["cpu"], res["f32"], label, card, dtype)


def bench_loop(torch, tr, step, state, inputs, warm, iters, peak=False):
    """bench.py's loop shape: ``warm`` steps, a read of the loss, then
    ``iters`` steps and one read of the loss at the end; returns (state,
    ms per step over the loop, each step's ms from CUDA events recorded
    between the steps, which add no sync)."""
    p, m, x = state
    keys, guard = tr._keys(), tr._guard_arrays()
    for _ in range(warm):
        p, m, x, loss, ok, guard = step(p, m, x, inputs, keys, guard)
    float(loss)
    if peak:
        torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(iters):
        p, m, x, loss, ok, guard = step(p, m, x, inputs, keys, guard)
        ev[i + 1].record()
    float(loss)
    dt = (time.perf_counter() - t0) / iters * 1e3
    tr._guard_state = guard
    check(bool(ok), "a bf16 step was skipped as non-finite")
    return (p, m, x), dt, [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def profiled_steps(torch, tr, step, state, inputs, n):
    """``n`` steps in the loop shape under torch.profiler: (state, device
    time by kernel, the steps' wall ms)."""
    from torch.profiler import ProfilerActivity, profile
    p, m, x = state
    keys, guard = tr._keys(), tr._guard_arrays()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            p, m, x, loss, ok, guard = step(p, m, x, inputs, keys, guard)
        float(loss)
        wall = (time.perf_counter() - t0) * 1e3
    tr._guard_state = guard
    return (p, m, x), device_by_kernel(prof), wall


# the f16 LM's loss scale, under the trainer's dynamic guard (halved on a
# non-finite step).  The LM's head is SoftmaxOutput, whose gradient
# ignores the incoming one (the reference's semantics, in both
# packages): a scale never reaches the gradients and the trainer's
# 1/scale only shrinks the update, so the scale a user of this graph
# picks is 1, with the guard on to skip a step that overflows.
F16_LOSS_SCALE = 1.0
# the LM's training check: the cross-entropy of the repeated batch falls
# by at least this much over the phase's steps (it falls by ~2.3 in bf16)
LM_CE_MARGIN = 1.0


def phase_lm_16(torch, kernels, get_symbol, ShardedTrainer, sgd_step_fn,
                flops_fn, card, kind):
    """The LM in ``kind`` (bf16, bench.py's default, or f16 with a dynamic
    loss scale of :data:`F16_LOSS_SCALE`): card vs CPU at a small size on
    the flash path, then full width in bench.py's loop shape through
    sgd_step_fn and build_step_auto_layout; returns the
    launch counts of the full-width runs and their ms per step."""
    small = dict(vocab_size=1000, seq_len=64, num_layers=2, hidden=64,
                 heads=4, flash_min_seq=1)
    dtype = {"bf16": "bfloat16", "f16": "float16"}[kind]
    scale = dict(loss_scale=F16_LOSS_SCALE, dynamic_loss_scale=True) \
        if kind == "f16" else {}

    def make(dev, pdt):
        return ShardedTrainer(get_symbol(**small), device=dev, lr=0.01,
                              momentum=0.9, wd=0.0, param_dtype=pdt,
                              **scale)

    bf16_step_triplet(torch, make, {"data": (4, 64), "softmax_label":
                                    (4, 64)},
                      lm_batch(1000, 4, 64, seed=7),
                      "LM L2 h64 T64 %s flash path, 1 step" % kind, card,
                      dtype)
    cfg = TRAIN
    B, T, L = 8, cfg["seq_len"], cfg["num_layers"]
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    batch = lm_batch(cfg["vocab_size"], B, T, seed=0)
    inputs = {n: torch.from_numpy(v).cuda() for n, v in batch.items()}
    flops = flops_fn(B, T, L, cfg["hidden"], cfg["vocab_size"])
    got, times = {}, {}
    for mode in ("sgd_step_fn", "build_step_auto_layout"):
        tr = ShardedTrainer(get_symbol(**cfg), lr=1e-4, momentum=0.9,
                            wd=0.0, param_dtype=dtype, **scale)
        state = tr.init_state(shapes, seed=0)
        dts = sorted({str(p.dtype).replace("torch.", "") for p in state[0]})
        if mode == "sgd_step_fn":
            step = sgd_step_fn(tr)
        else:
            step, *state = tr.build_step_auto_layout(*state, shapes)
        ce0 = cross_entropy(torch, tr, state[0], state[2], batch)
        if mode == "sgd_step_fn":
            # no host sync inside the step: the card runs ahead
            keys, guard = tr._keys(), tr._guard_arrays()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = step(*state, inputs, keys, guard)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            state, tr._guard_state = out[:3], out[5]
            log("LM %s %s: one step under set_sync_debug_mode(\"error\"): "
                "no host sync" % (kind, mode))
        torch.cuda.synchronize()
        kernels.reset_launches()
        warm, iters = 3, 20
        state, ms, per_step = bench_loop(torch, tr, step, state, inputs,
                                         warm, iters, peak=True)
        peak = torch.cuda.max_memory_allocated()
        state, by_kernel, wall = profiled_steps(torch, tr, step, state,
                                                inputs, 3)
        n_steps = warm + iters + 3
        counts = dict(kernels.LAUNCHES)
        for key in ("flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv"):
            check(counts[key + "_" + kind] == L * n_steps
                  and counts[key] == 0,
                  "%s: %s %s / %s f32 launches over %d steps, want %d %s"
                  % (key, counts[key + "_" + kind], kind, counts[key],
                     n_steps, L * n_steps, kind))
        ce1 = cross_entropy(torch, tr, state[0], state[2], batch)
        busy = sum(us for us, _ in by_kernel.values()) / 1e3
        mm = "matmuls (cuBLAS %s)" % kind
        groups = {"flash kernels (B9)": 0.0, mm: 0.0, "the rest": 0.0}
        for key, (us, _cnt) in by_kernel.items():
            low = key.lower()
            g = ("flash kernels (B9)" if "flash_" in low else
                 mm if any(
                     f in low for f in ("gemm", "nvjet", "xmma", "cutlass"))
                 else "the rest")
            groups[g] += us / 1e3 / 3
        log("LM %s L%d h%d V%d T%d batch %d through %s (params %s, "
            "bench.py's loop: %d warm-up, %d timed, the loss read once): "
            "%.2f ms per step = %.0f tokens/s; per-step events %.2f-%.2f "
            "ms (median %.2f); %.1f TFLOP/s = %.3f of the 989 TFLOP/s %s "
            "peak [%s]"
            % (kind, L, cfg["hidden"], cfg["vocab_size"], T, B, mode,
               "/".join(dts),
               warm, iters, ms, B * T / ms * 1e3, min(per_step),
               max(per_step), statistics.median(per_step), flops / ms / 1e9,
               flops / (ms / 1e3) / BF16_FLOPS_S, kind, card))
        # the profiler slows the host: the unprofiled loop's ms per step
        # is the other denominator of the same busy time
        log("  3 profiled steps: device busy %.2f ms per step; idle share "
            "%.3f of the profiled steps' %.2f ms, %.3f of the unprofiled "
            "loop's %.2f; per step by group: %s; peak memory %.2f GB; B9 "
            "launches %s over %d steps (%d per step each); cross-entropy "
            "of the repeated batch %.4f -> %.4f [%s]"
            % (busy / 3, 1 - busy / wall, wall / 3, 1 - busy / 3 / ms, ms,
               ", ".join("%s %.2f ms" % kv for kv in groups.items()),
               peak / 1e9,
               {k: v for k, v in counts.items() if v}, n_steps, L, ce0, ce1,
               card))
        log("  B9's share of the step: %.2f ms per step = %.3f of the "
            "device busy time, %.3f of the unprofiled loop's step [%s]"
            % (groups["flash kernels (B9)"],
               groups["flash kernels (B9)"] / (busy / 3),
               groups["flash kernels (B9)"] / ms, card))
        if scale:
            # the raw step counts nothing on the host; the guard's streak
            # of good steps on the device goes to 0 at a skipped step and
            # grows by one at every other (reset by growth only after
            # loss_scale_growth_interval good steps, more than the run
            # takes), so it equals the steps taken iff none was skipped
            taken = n_steps + (mode == "sgd_step_fn")
            streak = int(tr._guard_state[1])
            check(tr.loss_scale_growth_interval > taken,
                  "the f16 LM's growth interval %d does not outlast its %d "
                  "steps" % (tr.loss_scale_growth_interval, taken))
            log("  loss scale: %g at the start, %g at the end; the guard's "
                "streak of good steps %d of the %d steps taken: %s [%s]"
                % (F16_LOSS_SCALE, tr.loss_scale, streak, taken,
                   "none skipped" if streak == taken else
                   "at least one skipped, the last at step %d"
                   % (taken - streak), card))
            check(streak == taken, "the f16 LM skipped a step as "
                  "non-finite (the guard's streak %d of %d steps)"
                  % (streak, taken))
        check(np.isfinite(ce0) and np.isfinite(ce1)
              and ce1 <= ce0 - LM_CE_MARGIN,
              "the %s LM did not lower the cross-entropy of the repeated "
              "batch by %g (%.4f -> %.4f)" % (kind, LM_CE_MARGIN, ce0, ce1))
        got[mode], times[mode] = counts, ms
        del state, tr, step
        torch.cuda.empty_cache()
    return got, times


def phase_resnet50_bf16(torch, kernels, ShardedTrainer, sgd_step_fn, card):
    """ResNet-50 in bf16 at bench.py's configuration (NCHW), through
    build_step_auto_layout (channels-last convolution weights) and through
    sgd_step_fn; card vs CPU first at the cifar ResNet-20 size."""
    from mxnet_tpu_torch.models import resnet

    def make(dev, pdt):
        kw = dict(CIFAR20[1], num_classes=10,
                  dtype="bfloat16" if pdt else "float32")
        return ShardedTrainer(resnet.get_symbol(**kw), device=dev, lr=0.1,
                              momentum=0.9, wd=1e-4, param_dtype=pdt)

    rs = np.random.RandomState(4)
    bf16_step_triplet(
        torch, make, {"data": (4, 3, 12, 12), "softmax_label": (4,)},
        {"data": rs.randn(4, 3, 12, 12).astype(np.float32),
         "softmax_label": rs.randint(0, 10, 4).astype(np.float32)},
        "cifar ResNet-20 12x12 bf16, 1 step", card)
    torch.backends.cudnn.benchmark = True
    kernels.reset_launches()
    kw = dict(RESNET50, layout="NCHW", dtype="bfloat16")
    shapes = conv_net_shapes(kw, RESNET_BATCH, "NCHW")
    net = resnet.get_symbol(**kw)
    flops = train_flops(net, shapes)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {"data": torch.randn(shapes["data"], generator=gen,
                                  device="cuda"),
              "softmax_label": torch.randint(0, 1000, (RESNET_BATCH,),
                                             generator=gen,
                                             device="cuda").float()}
    times = {}
    for mode in ("build_step_auto_layout", "sgd_step_fn"):
        tr = ShardedTrainer(net, lr=0.1, momentum=0.9, wd=1e-4,
                            param_dtype="bfloat16")
        state = tr.init_state(shapes, seed=0)
        if mode == "sgd_step_fn":
            step = sgd_step_fn(tr)
        else:
            step, *state = tr.build_step_auto_layout(*state, shapes)
            n_cl = sum(p.dim() == 4 and p.is_contiguous(
                memory_format=torch.channels_last) for p in state[0])
            check(n_cl == 53, "%d channels-last conv weights, want 53"
                  % n_cl)
        ce0 = train_ce(torch, tr, state[0], state[2], inputs["data"],
                       inputs["softmax_label"])
        warm, iters = 3, 20
        state, ms, per_step = bench_loop(torch, tr, step, state, inputs,
                                         warm, iters, peak=True)
        peak = torch.cuda.max_memory_allocated()
        state, by_kernel, wall = profiled_steps(torch, tr, step, state,
                                                inputs, 2)
        ce1 = train_ce(torch, tr, state[0], state[2], inputs["data"],
                       inputs["softmax_label"])
        busy = sum(us for us, _ in by_kernel.values()) / 1e3
        groups = {g: 0.0 for g, _ in CONV_GROUPS}
        groups["other"] = 0.0
        for key, (us, _cnt) in by_kernel.items():
            low = key.lower()
            g = next((g for g, frags in CONV_GROUPS
                      if any(f in low for f in frags)), "other")
            groups[g] += us / 1e3 / 2
        log("ResNet-50 NCHW 224x224 batch %d bf16 through %s (bench.py's "
            "loop: %d warm-up, %d timed, the loss read once; cudnn.benchmark "
            "on): %.2f ms per step = %.1f images/s; per-step events "
            "%.2f-%.2f ms (median %.2f); %.2f TFLOP/s = %.3f of the 989 "
            "TFLOP/s bf16 peak [%s]"
            % (RESNET_BATCH, mode, warm, iters, ms, RESNET_BATCH / ms * 1e3,
               min(per_step), max(per_step), statistics.median(per_step),
               flops / ms / 1e9, flops / (ms / 1e3) / BF16_FLOPS_S, card))
        log("  2 profiled steps: device busy %.2f ms per step; idle share "
            "%.3f of the profiled steps' %.2f ms, %.3f of the unprofiled "
            "loop's %.2f; per step by group: %s; top kernels: %s; peak "
            "memory %.2f GB; cross-entropy of the repeated batch %.4f -> "
            "%.4f [%s]"
            % (busy / 2, 1 - busy / wall, wall / 2, 1 - busy / 2 / ms, ms,
               ", ".join(
                "%s %.2f ms" % kv for kv in sorted(groups.items(),
                                                   key=lambda kv: -kv[1])),
               "; ".join("%.0f us x%d %s" % (us / 2, cnt // 2, k[:60])
                         for k, (us, cnt) in sorted(
                             by_kernel.items(), key=lambda kv: -kv[1][0])[:4]),
               peak / 1e9, ce0, ce1, card))
        times[mode] = ms
        del state, tr, step
        torch.cuda.empty_cache()
        ok, c0, ces = resnet_loss_check(torch, ShardedTrainer, sgd_step_fn,
                                        net, shapes, inputs, mode,
                                        "bfloat16")
        log("  training check: a fresh trainer at lr %g, %d steps: "
            "cross-entropy %.4f -> %s; must fall by %g: %s [%s]"
            % (RESNET_CHECK["lr"], RESNET_CHECK["steps"], c0,
               ", ".join("%.3f" % c for c in ces), RESNET_CHECK["margin"],
               "passed" if ok else "FAILED", card))
        check(ok, "ResNet-50 bf16 (%s): the training check's cross-entropy "
              "did not fall by %g (%.4f -> %.4f)"
              % (mode, RESNET_CHECK["margin"], c0, ces[-1]))
        torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    got = dict(kernels.LAUNCHES)
    check(not any(got.values()), "the bf16 ResNet path launched a "
          "hand-written kernel: %s" % got)
    log("ResNet-50 bf16: auto-layout %.2f ms vs raw %.2f ms per step (%s is "
        "the faster); no hand-written kernel launched [%s]"
        % (times["build_step_auto_layout"], times["sgd_step_fn"],
           min(times, key=times.get), card))
    return got


# B11: the embedding kernels at the table's dtype (bf16, f16, f64)
B11_KINDS = (("bf16", "bfloat16"), ("f16", "float16"), ("f64", "float64"))
B11_RAGGED = ((1000, 13, 257), (50, 16, 1), (77, 64, 40), (3, 1, 9),
              (300, 7, 1200))


def b11_case(torch, sk, dtype, rows, D, n, seed, dev, path=False):
    """B5 and B6 (add and set) at ``dtype`` against their plain versions,
    exactly, on one shape: an inexact table and inexact payloads rounded
    to the table's dtype, so every add rounds and the order of the adds
    shows.  The add's ids are sorted with a run of duplicates (long runs
    where n > rows), the ids 0 and rows-1 and 3 pads with zero payloads;
    the gather's and the set's are the path's (sorted unique ids, then
    pads equal to ``rows`` carrying the current last row; the gather's
    clamped) where ``path``, else the add's.  Two launches of each are
    bit-equal.  Returns the tensors the timing needs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    table = (torch.randn(rows, D, generator=g, device=dev) * 10).to(dtype)
    rs = np.random.RandomState(seed)
    raw = rs.randint(0, rows, n)
    raw[0], raw[-1] = 0, rows - 1
    if n > 4:
        raw[1:4] = raw[2]
    t = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    add_ids = t(np.concatenate([np.sort(raw), rows + np.arange(3)]))
    if path:
        n_u, sc, ga = path_ids(rs, rows, n)
        sc, ga = t(sc), t(ga)
    else:
        sc, ga = add_ids, add_ids.clamp(max=rows - 1)
        n_u = int(torch.unique(ga).numel())
    add_src = torch.randn(add_ids.numel(), D, generator=g,
                          device=dev).to(dtype)
    add_src[-3:] = 0
    set_src = torch.randn(sc.numel(), D, generator=g, device=dev).to(dtype)
    set_src = torch.where((sc < rows)[:, None], set_src, table[rows - 1])
    got, again, want = {}, {}, {}
    for out in (got, again):
        out["gather"] = sk.embedding_gather(table, ga)
        out["set"] = sk.embedding_scatter(table.clone(), sc, set_src, "set")
        out["add"] = sk.embedding_scatter(table.clone(), add_ids, add_src,
                                          "add")
    want["gather"] = sk.embedding_gather_plain(table, ga)
    want["set"] = sk.embedding_scatter_plain(table.clone(), sc, set_src,
                                             "set")
    want["add"] = sk.embedding_scatter_plain(table.clone(), add_ids,
                                             add_src, "add")
    torch.cuda.synchronize()
    errs = {k: (got[k].double() - want[k].double()).abs().max().item()
            for k in got}
    same = {k: torch.equal(got[k], want[k]) and torch.equal(got[k], again[k])
            and got[k].dtype == dtype for k in got}
    log("embedding kernels %s rows %d D %d n %d (%d unique; runs, pads, ids "
        "0 and rows-1; inexact): max_abs_err %s (tolerance 0: the kernel "
        "rounds as its plain version does), reruns bit-equal"
        % (dtype, rows, D, n, n_u,
           ", ".join("%s=%.3g" % kv for kv in errs.items())))
    check(all(same.values()), "the embedding kernels in %s disagree with "
          "their plain versions or with themselves at rows %d D %d n %d: %s"
          % (dtype, rows, D, n, same))
    return dict(table=table, sc=sc, ga=ga, set_src=set_src, add_ids=add_ids,
                add_src=add_src, n_u=n_u, errs=errs,
                add_rows=int(torch.unique(add_ids.clamp(max=rows - 1))
                             .numel()))


def b11_mixed_groups(torch, kernels, sk, timer, tag, geo, dev):
    """The bf16 recommender's update gather at ``geo``: every table's bf16
    rows and its float32 momentum rows in one launch, exactly equal to
    the plain version, each output in its buffer's dtype; timed."""
    rows, D, n, F = geo["rows"], geo["dim"], geo["batch"], geo["tables"]
    g = torch.Generator(device=dev).manual_seed(17)
    tabs = [torch.randn(rows, D, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(F)]
    moms = [torch.randn(rows, D, generator=g, device=dev) for _ in range(F)]
    rs = np.random.RandomState(17)
    bufs, idx = [], []
    for f in range(F):
        i = torch.from_numpy(path_ids(rs, rows, n)[2]).to(dev)
        bufs += [tabs[f], moms[f]]
        idx += [i, i]
    before = kernels.LAUNCHES["embedding_gather"]
    got = sk.embedding_gather_many(bufs, idx)
    want = sk.embedding_gather_many_plain(bufs, idx)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["embedding_gather"] == before + 1,
          "the mixed-dtype update gather took more than one launch")
    check(all(a.dtype == b.dtype and torch.equal(a, w)
              for a, b, w in zip(got, bufs, want)),
          "the mixed-dtype grouped gather differs from its plain version "
          "(%s)" % tag)
    del got, want
    nbytes = F * (n * 4 + 2 * n * D * 2) + F * (n * 4 + 2 * n * D * 4)
    b, by = bound_ms(nbytes, 0)
    row = {
        "name": "embedding_gather", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/embedding.cu",
        "replaces": "mxnet_tpu/sparse/kernels.py:117",
        "shape": "%s update, bf16 tables: %d segments (%d tables (%d, %d) "
                 "bf16 + their f32 momentum), n %d each, grouped"
                 % (tag, 2 * F, F, rows, D, n),
        "launches_per_step": 1, "max_abs_err": 0.0,
        "ms": timer(lambda: sk.embedding_gather_many(bufs, idx)),
        "plain_ms": timer(lambda: sk.embedding_gather_many_plain(bufs,
                                                                 idx)),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "library_call": "none: no single PyTorch call gathers from many "
                        "tables",
    }
    del tabs, moms, bufs
    return row


def phase_embedding_b11(torch, kernels, sk, timer, card):
    """B5 and B6 in bf16, f16 and f64 against their plain versions,
    exactly, at ragged shapes and at the recommender's (timed, with the
    bytes bound and the ``index_select`` / ``index_copy_`` / ``index_add_``
    yardsticks in the same dtype), then the bf16 update gather with f32
    momentum in one launch at both geometries."""
    dev = torch.device("cuda")
    out = []
    src = "mxnet_tpu_torch/csrc/embedding.cu"
    for kind, name in B11_KINDS:
        dtype = getattr(torch, name)
        size = dtype.itemsize
        for rows, D, n in B11_RAGGED:
            b11_case(torch, sk, dtype, rows, D, n, rows + D + n, dev)
        for tag, geo in (("bench", REC), ("criteo", CRITEO)):
            rows, D, n = geo["rows"], geo["dim"], geo["batch"]
            c = b11_case(torch, sk, dtype, rows, D, n, 7, dev, path=True)
            table, sc, ga = c["table"], c["sc"], c["ga"]
            shape = "%s: table (%d, %d) %s, n %d (%d unique + pads)" % (
                tag, rows, D, kind, n, c["n_u"])
            row_b = D * size
            set_rows = c["n_u"] + int(rows - 1 not in set(
                sc[:c["n_u"]].tolist()))
            b_g, by_g = bound_ms(n * 4 + 2 * n * row_b, 0)
            b_s, by_s = bound_ms(n * 4 + n * row_b + set_rows * row_b, 0)
            na = c["add_ids"].numel()
            b_a, by_a = bound_ms(na * 4 + na * row_b
                                 + 2 * c["add_rows"] * row_b, na * D)
            ga_l, sc_l = ga.long(), sc.clamp(max=rows - 1).long()
            add_l = c["add_ids"].clamp(max=rows - 1).long()
            t_set, t_add = table.clone(), table.clone()
            out += [{
                "name": "embedding_gather", "route": "cuda", "source": src,
                "replaces": "mxnet_tpu/sparse/kernels.py:117",
                "shape": shape + ", one segment (lookup or apply_* alone; "
                         "not on the step's path)",
                "launches_per_step": 0,
                "max_abs_err": c["errs"]["gather"],
                "ms": timer(lambda: sk.embedding_gather(table, ga)),
                "plain_ms": timer(lambda: sk.embedding_gather_plain(table,
                                                                    ga)),
                "bound_ms": b_g, "bound_by": by_g,
                "library_ms": timer(lambda: torch.index_select(table, 0,
                                                               ga_l)),
                "library_call": "torch.index_select(table, 0, ids), %s"
                                % kind,
            }, {
                "name": "embedding_scatter_" + kind, "route": "cuda",
                "source": src,
                "replaces": "mxnet_tpu/sparse/kernels.py:175",
                "shape": shape + ", set",
                "launches_per_step": REC["tables"] if kind == "bf16" else 0,
                "max_abs_err": c["errs"]["set"],
                "ms": timer(lambda: sk.embedding_scatter(
                    t_set, sc, c["set_src"], "set")),
                "plain_ms": timer(lambda: sk.embedding_scatter_plain(
                    t_set, sc, c["set_src"], "set")),
                "bound_ms": b_s, "bound_by": by_s,
                "library_ms": timer(lambda: t_set.index_copy_(
                    0, sc_l, c["set_src"])),
                "library_call": "table.index_copy_(0, clamped ids, rows), "
                                "%s" % kind,
            }, {
                "name": "embedding_scatter_" + kind, "route": "cuda",
                "source": src,
                "replaces": "mxnet_tpu/sparse/kernels.py:175",
                "shape": "%s: table (%d, %d) %s, n %d sorted with "
                         "duplicates + 3 pads, add (not on the step's "
                         "path)" % (tag, rows, D, kind, na - 3),
                "launches_per_step": 0,
                "max_abs_err": c["errs"]["add"],
                "ms": timer(lambda: sk.embedding_scatter(
                    t_add, c["add_ids"], c["add_src"], "add")),
                "plain_ms": timer(lambda: sk.embedding_scatter_plain(
                    t_add, c["add_ids"], c["add_src"], "add")),
                "bound_ms": b_a, "bound_by": by_a,
                "library_ms": timer(lambda: t_add.index_add_(
                    0, add_l, c["add_src"])),
                "library_call": "table.index_add_(0, clamped ids, rows), "
                                "%s (atomics: another order)" % kind,
            }]
            del c, table, t_set, t_add
            torch.cuda.empty_cache()
    for tag, geo in (("bench", REC), ("criteo", CRITEO)):
        out.append(b11_mixed_groups(torch, kernels, sk, timer, tag, geo,
                                    dev))
        torch.cuda.empty_cache()
    for r in out:
        log("  %-22s %-66s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "library_ms=%s  [%s]"
            % (r["name"], r["shape"], r["ms"], r["plain_ms"], r["bound_ms"],
               r["bound_by"], "none" if r["library_ms"] is None
               else "%.4f" % r["library_ms"], card))
    return out


def phase_rec_bf16_parity(torch, tsp, MeshSpec, make_mesh, convert, card):
    """Two steps of the recommender over bf16 tables on the card and on
    the CPU (plain versions) from one state: 4 tables x 1000 x 16, batch
    512.  Tables within one bf16 step of the CPU's per element plus 1e-3
    of their largest update (a new row's f32 value rounds once to bf16,
    and the two devices' f32 values may straddle a rounding boundary);
    momentum and MLP within 1e-3 of their largest update; losses within
    1e-5."""
    geo = dict(REC, rows=1000, batch=512)
    F = geo["tables"]
    batches = [rec_batch(torch, geo, 20 + i, "cpu") for i in range(2)]
    res, start = {}, None
    for dev in ("cpu", "cuda"):
        spec = MeshSpec(make_mesh((1,), ("dp",), device=dev))
        embs = [tsp.ShardedEmbedding(geo["rows"], geo["dim"], spec,
                                     dtype="bfloat16", name="pb%d" % f)
                for f in range(F)]
        if start is None:
            start = tsp.recommender_state(embs, dense_dim=geo["dense"],
                                          hidden=geo["hidden"], seed=3)
        state = {k: (tuple(t.to(dev, copy=True) for t in v)
                     if isinstance(v, tuple) else
                     {n: t.to(dev, copy=True) for n, t in v.items()})
                 for k, v in start.items()}
        step = tsp.make_recommender_step(embs, lr=geo["lr"],
                                         momentum=geo["momentum"])
        losses = []
        for b in batches:
            state, loss = step(state, {k: v.to(dev) for k, v in b.items()})
            losses.append(float(loss))
        check(all(t.dtype == torch.bfloat16 for t in state["tables"]),
              "a bf16 table changed dtype")
        res[dev] = (convert.recommender_state_to_numpy(state), losses)
    s0 = convert.recommender_state_to_numpy(start)
    (cpu, l_cpu), (crd, l_card) = res["cpu"], res["cuda"]
    worst, steps_off = 0.0, 0
    for i, (a, b) in enumerate(zip(cpu["tables"], crd["tables"])):
        upd = np.abs(a - s0["tables"][i]).max()
        step_bf16 = np.abs(a) * 2.0 ** -7
        over = np.abs(a - b) > 1e-3 * upd
        steps_off += int(over.sum())
        check((np.abs(a - b) <= step_bf16 + 1e-3 * upd).all(),
              "bf16 table %d on the card differs from the CPU by more than "
              "one bf16 step" % i)
    for p in ("moms",):
        for i, (a, b) in enumerate(zip(cpu[p], crd[p])):
            upd = np.abs(a - s0[p][i]).max()
            err = np.abs(a - b).max()
            worst = max(worst, err / upd)
            check(err <= 1e-3 * upd, "%s[%d] differs card vs CPU" % (p, i))
    for p in ("mlp", "mlp_mom"):
        for k in cpu[p]:
            upd = np.abs(cpu[p][k] - s0[p][k]).max()
            err = np.abs(cpu[p][k] - crd[p][k]).max()
            worst = max(worst, err / upd)
            check(err <= 1e-3 * upd, "%s.%s differs card vs CPU" % (p, k))
    lerr = max(abs(a - b) for a, b in zip(l_cpu, l_card))
    log("bf16 recommender 2 steps card vs cpu (%d x %d x %d, batch %d): "
        "tables within one bf16 step (%d elements off by a rounding), "
        "momentum and MLP within %.3g of their largest update (tolerance "
        "1e-3); losses %s vs %s, max diff %.3g (tolerance 1e-5) [%s]"
        % (F, geo["rows"], geo["dim"], geo["batch"], steps_off, worst,
           ["%.7f" % v for v in l_card], ["%.7f" % v for v in l_cpu], lerr,
           card))
    check(lerr <= 1e-5, "bf16 recommender losses on the card differ from "
          "the CPU")


# the small LM of the Module parity phases and the optimizers the card
# runs it with: (name, optimizer_params)
SMALL_LM = dict(vocab_size=1024, seq_len=64, num_layers=2, hidden=64,
                heads=4)
CARD_OPTIMIZERS = (
    ("adam", dict(learning_rate=1e-3)),
    ("nag", dict(learning_rate=0.05, momentum=0.9)),
    ("rmsprop", dict(learning_rate=1e-3)),
    ("rmsprop", dict(learning_rate=1e-3, centered=True, gamma2=0.8)),
    ("adagrad", dict(learning_rate=0.01)),
    ("adadelta", dict(rho=0.9)),
    ("adamax", dict(learning_rate=2e-3)),
    ("nadam", dict(learning_rate=1e-3)),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.001)),
    ("ftml", dict(learning_rate=2e-3)),
    ("signum", dict(learning_rate=1e-3, momentum=0.9)),
    ("sgld", dict(learning_rate=1e-4)),
    ("dcasgd", dict(learning_rate=0.05, momentum=0.9)),
    ("lbsgd", dict(learning_rate=0.05, momentum=0.9,
                   warmup_strategy="lars")),
)


def small_lm_fit(mx, net, X, Y, dev, opt, params, start):
    """One epoch of ``Module.fit`` of the small LM (batch 4, a local
    updater) on ``dev`` from ``start`` (host arrays); returns the
    Module."""
    ctx = mx.gpu(0) if dev == "cuda" else mx.cpu()
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(mx.io.NDArrayIter(X, Y, batch_size=4), kvstore="local",
            optimizer=opt, optimizer_params=dict(params),
            eval_metric=mx.metric.Perplexity(ignore_label=None),
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in start.items()},
            num_epoch=1)
    return mod


def host_params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def phase_optimizers_parity(torch, mx, get_symbol, card):
    """Each optimizer of ``CARD_OPTIMIZERS`` for three ``Module.fit``
    steps of the small LM on the card (a local updater: one call per key
    and step), every update held to the CPU's: each call's gradient and
    weight are recorded on the card and the same calls replayed on the
    CPU by a fresh optimizer of the same settings (its states its own),
    the weight after each within 1e-6 of its largest magnitude before or
    after the update (float32 elementwise ops on both devices; the states
    drift by ulps).  SGLD's
    noise comes from each device's own generator: the CPU replays it with
    the noise drawn as zeros, and the card's increment over that
    deterministic part must have mean 0 and variance lr (within 5
    standard errors).  Then the same fit on the CPU end to end: the
    weights' card-vs-CPU gap, norm-wise over all parameters, is printed
    (the normalising optimizers turn gradients that are rounding noise
    into steps of lr, so an element's gap says little there)."""
    from mxnet_tpu_torch import optimizer as opt_mod
    import mxnet_tpu_torch.ndarray.random as nd_random
    cfg = SMALL_LM
    B, T = 4, cfg["seq_len"]
    net = get_symbol(**cfg)
    rs = np.random.RandomState(29)
    X = rs.randint(0, cfg["vocab_size"], (3 * B, T)).astype(np.float32)
    Y = rs.randint(0, cfg["vocab_size"], (3 * B, T)).astype(np.float32)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    start = module_params(net, shapes, seed=5)
    for opt, params in CARD_OPTIMIZERS:
        label = opt + ("-centered" if params.get("centered") else "")
        calls = []
        orig_call = opt_mod.Updater.__call__

        def recording(self, index, grad, weight):
            before = weight.asnumpy()
            orig_call(self, index, grad, weight)
            calls.append((index, grad.asnumpy(), before, weight.asnumpy()))

        opt_mod.Updater.__call__ = recording
        try:
            mx.random.seed(1)
            mod = small_lm_fit(mx, net, X, Y, "cuda", opt, params, start)
        finally:
            opt_mod.Updater.__call__ = orig_call
        card_w = host_params(mod)
        settings = dict(params, rescale_grad=mod._optimizer.rescale_grad,
                        param_idx2name=dict(mod._optimizer.idx2name),
                        sym=net)
        del mod
        check(len(calls) == 3 * len(start), "%s: %d updater calls, want %d"
              % (label, len(calls), 3 * len(start)))
        replay = opt_mod.get_updater(opt_mod.create(opt, **settings))
        orig_normal = nd_random.normal
        if opt == "sgld":
            nd_random.normal = lambda *a, shape=(), dtype="float32", \
                ctx=None, **k: mx.nd.zeros(shape, dtype=dtype, ctx=ctx)
        worst, noise = 0.0, []
        try:
            for index, g, before, after in calls:
                w = mx.nd.array(before, ctx=mx.cpu())
                replay(index, mx.nd.array(g, ctx=mx.cpu()), w)
                got = w.asnumpy()
                if opt == "sgld":
                    if after.size >= 4096:
                        noise.append((after - got).ravel())
                    continue
                err = float(np.abs(after - got).max())
                scale = max(float(np.abs(got).max()),
                            float(np.abs(before).max()))
                if scale:
                    worst = max(worst, err / scale)
                check(err <= 1e-6 * scale, "%s: the card's update of key %s "
                      "differs from the CPU's by %.3g (largest magnitude "
                      "%.3g)" % (label, index, err, scale))
        finally:
            nd_random.normal = orig_normal
        mx.random.seed(1)
        cpu_w = host_params(small_lm_fit(mx, net, X, Y, "cpu", opt, params,
                                         start))
        gap = np.sqrt(sum(float(((card_w[k] - cpu_w[k]) ** 2).sum())
                          for k in start))
        moved = np.sqrt(sum(float(((cpu_w[k] - start[k]) ** 2).sum())
                            for k in start))
        check(all(np.isfinite(v).all() for v in card_w.values())
              and moved > 0, "%s: the card's fit gave non-finite or "
              "unmoved weights" % label)
        if opt == "sgld":
            z = np.concatenate(noise).astype(np.float64)
            lr = params["learning_rate"]
            se_mean = np.sqrt(lr / z.size)
            se_var = lr * np.sqrt(2.0 / z.size)
            log("  %-16s %d updates on the card; its noise over %d "
                "elements: mean %.3g (standard error %.3g), variance %.5g "
                "(lr %.5g, standard error %.3g); end to end card vs cpu "
                "%.3g of the update norm-wise [%s]"
                % (label, len(calls), z.size, z.mean(), se_mean, z.var(),
                   lr, se_var, gap / moved, card))
            check(abs(z.mean()) <= 5 * se_mean
                  and abs(z.var() - lr) <= 5 * se_var,
                  "sgld's noise on the card is not N(0, lr)")
            continue
        log("  %-16s %d updates on the card, each within %.3g of its "
            "largest magnitude of the CPU's replay (tolerance 1e-6); end "
            "to end card vs cpu %.3g of the update norm-wise [%s]"
            % (label, len(calls), worst, gap / moved, card))


def phase_checkpoint_resume(torch, mx, get_symbol, card):
    """On the card: ``fit`` the small LM for two epochs (3 batches each,
    SGD with momentum, then Adam) with ``module_checkpoint(...,
    save_optimizer_states=True)``; ``Module.load(prefix, 1,
    load_optimizer_states=True)`` and ``fit(begin_epoch=1)`` must give
    the uninterrupted run's weights bit for bit."""
    import tempfile
    cfg = SMALL_LM
    B, T = 4, cfg["seq_len"]
    net = get_symbol(**cfg)
    rs = np.random.RandomState(31)
    X = rs.randint(0, cfg["vocab_size"], (3 * B, T)).astype(np.float32)
    Y = rs.randint(0, cfg["vocab_size"], (3 * B, T)).astype(np.float32)
    start = module_params(net, {"data": (B, T), "softmax_label": (B, T)},
                          seed=6)
    for opt, params in (("sgd", dict(learning_rate=0.05, momentum=0.9)),
                        ("adam", dict(learning_rate=1e-3))):
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "lm")
            mod = mx.mod.Module(net, context=mx.gpu(0))
            mod.fit(mx.io.NDArrayIter(X, Y, batch_size=B), kvstore="local",
                    optimizer=opt, optimizer_params=dict(params),
                    eval_metric=mx.metric.Perplexity(ignore_label=None),
                    arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in start.items()},
                    epoch_end_callback=mx.callback.module_checkpoint(
                        mod, prefix, save_optimizer_states=True),
                    num_epoch=2)
            whole = host_params(mod)
            files = sorted(os.listdir(tmp))
            del mod
            resumed = mx.mod.Module.load(prefix, 1,
                                         load_optimizer_states=True,
                                         context=mx.gpu(0))
            p2 = dict(params)
            if opt == "adam":       # the step count resumes with the states
                p2["begin_num_update"] = 3
            resumed.fit(mx.io.NDArrayIter(X, Y, batch_size=B),
                        kvstore="local", optimizer=opt, optimizer_params=p2,
                        eval_metric=mx.metric.Perplexity(ignore_label=None),
                        begin_epoch=1, num_epoch=2)
            got = host_params(resumed)
            del resumed
        same = all(np.array_equal(got[k], whole[k]) for k in whole)
        moved = max(float(np.abs(whole[k] - start[k]).max()) for k in start)
        log("  checkpoint and resume on the card (%s; files %s): resumed "
            "weights equal to the uninterrupted run's bit for bit: %s "
            "(largest update %.3g) [%s]" % (opt, ", ".join(files), same,
                                           moved, card))
        check(same and moved > 0, "%s: the resumed fit differs from the "
              "uninterrupted one" % opt)


def phase_adam_fit(torch, mx, kernels, get_symbol, card):
    """``Module.fit`` of the full-width LM with Adam through a 2-bit
    ``KVStore("device")`` (the store runs Adam per key): 16 numpy-seeded
    sequences, 2 batches of 8 per epoch, 2 warm-up and 8 timed steps
    (CUDA events at batch end), tokens/s, host ms in ``update()``, one
    B7 launch per step, peak memory, the perplexity falling."""
    cfg = TRAIN
    B, T = 8, cfg["seq_len"]
    warm, timed = 2, 8
    epochs = (warm + timed) // 2
    net = get_symbol(**cfg)
    rs = np.random.RandomState(0)
    X = rs.randint(0, cfg["vocab_size"], (2 * B, T)).astype(np.float32)
    Y = rs.randint(0, cfg["vocab_size"], (2 * B, T)).astype(np.float32)
    it = mx.io.NDArrayIter(X, Y, batch_size=B, label_name="softmax_label")
    mod = mx.mod.Module(net, compression_params={"type": "2bit",
                                                 "threshold": 0.5})
    kv = mx.kv.create("device")
    update_ms, ev, ppl, launches = [], [], [], []
    orig_update = mod.update

    def timed_update():
        t0 = time.perf_counter()
        orig_update()
        update_ms.append((time.perf_counter() - t0) * 1e3)

    def on_batch(p):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)
        launches.append(kernels.LAUNCHES["two_bit_compress"])
        if p.nbatch == 1:
            ppl.append(p.eval_metric.get()[1])

    mod.update = timed_update
    mx.random.seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    mod.fit(it, kvstore=kv, optimizer="adam",
            optimizer_params={"learning_rate": 1e-4},
            initializer=mx.init.Xavier(),
            eval_metric=mx.metric.Perplexity(ignore_label=None),
            batch_end_callback=on_batch, num_epoch=epochs)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = len(ev)
    n_keys = len(mod._exec_group.param_names)
    per_step = -(-n_keys // kernels.two_bit_segments_per_launch())
    check(steps == 2 * epochs, "fit ran %d steps" % steps)
    check(got["two_bit_compress"] == per_step * steps,
          "two_bit_compress launched %d times over %d steps, want %d per "
          "step" % (got["two_bit_compress"], steps, per_step))
    check(isinstance(kv._updater.optimizer, mx.optimizer.Adam),
          "the store did not run Adam")
    inner = [ev[i - 2].elapsed_time(ev[i - 1])
             for i in range(warm + 1, warm + timed + 1) if i % 2 == 0]
    every = [ev[i - 2].elapsed_time(ev[i - 1])
             for i in range(warm + 1, warm + timed + 1)]
    med = statistics.median(inner)
    log("Module.fit L%d h%d V%d T%d batch %d f32 with Adam (lr 1e-4) "
        "through KVStore('device') with 2-bit compression, %d keys: %d "
        "steps in %.1f s" % (cfg["num_layers"], cfg["hidden"],
                             cfg["vocab_size"], T, B, n_keys, steps, fit_s))
    log("  step ms (CUDA events at batch end): %s; steps inside an epoch "
        "median %.3f = %.0f tokens/s [%s]"
        % (", ".join("%.3f" % x for x in every), med, B * T / med * 1e3,
           card))
    log("  host ms in update() per timed step: %s (median %.2f); "
        "two_bit_compress launches per step: %s; peak memory %.2f GB [%s]"
        % (", ".join("%.1f" % x for x in update_ms[warm:]),
           statistics.median(update_ms[warm:]),
           ", ".join(str(b - a) for a, b in zip([0] + launches, launches)),
           peak / 1e9, card))
    log("  perplexity per epoch (before each epoch's second update): %s"
        % ", ".join("%.2f" % x for x in ppl))
    check(np.isfinite(ppl).all() and ppl[-1] < ppl[0],
          "the perplexity did not fall under Adam (%.4f -> %.4f)"
          % (ppl[0], ppl[-1]))
    del mod, kv
    return got


# phase 30: BucketingModule over length buckets, and remat
BUCKET_SMALL = dict(vocab_size=1000, num_layers=2, hidden=64, heads=4)
BUCKET_FULL = dict(vocab_size=TRAIN["vocab_size"], num_layers=12,
                   hidden=768, heads=12)
BUCKET_LR = 1e-4         # as phase 14: lr 0.1 diverges to NaN (30a's LM)
FLASH_KEYS = ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")


def bucket_sym_gen(sym, block, vocab_size, num_layers, hidden, heads,
                   flash_min_seq):
    """A user's sym_gen for length buckets: the LM of
    ``models.transformer.get_symbol``, its positions declared at 1024 and
    sliced to the bucket's length, so that every bucket shares them."""
    def sym_gen(T):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        pos = sym.Variable("pos_embed", shape=(1024, hidden))
        tok = sym.Embedding(data, input_dim=vocab_size, output_dim=hidden,
                            name="tok_embed")
        x = sym.broadcast_add(tok, sym.expand_dims(
            sym.slice_axis(pos, axis=0, begin=0, end=T), axis=0))
        for i in range(num_layers):
            x = block(x, hidden, heads, T, i, flash_min_seq=flash_min_seq)
        x = sym.LayerNorm(x, name="ln_f")
        logits = sym.FullyConnected(x, num_hidden=vocab_size, flatten=False,
                                    name="head")
        logits = sym.Reshape(logits, shape=(-1, vocab_size))
        out = sym.SoftmaxOutput(logits, sym.Reshape(label, shape=(-1,)),
                                name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def bucket_sentences(vocab, per_bucket, buckets, seed):
    """``per_bucket`` sentences of each bucket, lengths uniform in (the
    bucket below, the bucket], ids in [1, vocab) (0 pads), drawn with
    numpy from ``seed`` as phase 14 draws its data."""
    rs = np.random.RandomState(seed)
    out = []
    for lo, hi in zip([buckets[0] // 2] + list(buckets[:-1]), buckets):
        for _ in range(per_bucket):
            out.append(list(rs.randint(1, vocab, int(rs.randint(lo + 1,
                                                                 hi + 1)))))
    return out


def bucket_iter(mx, sentences, batch, buckets, seed):
    """The BucketSentenceIter of ``sentences``; its batch order comes from
    the global ``random`` and ``np.random``, seeded here."""
    import random
    random.seed(seed)
    np.random.seed(seed)
    return mx.rnn.BucketSentenceIter(sentences, batch, buckets=buckets,
                                     invalid_label=0)


def flash_at_lengths(torch, kernels, F, timer, card):
    """B1, B2a and B2b against their plain versions at T 256 and 512
    (B8 H12 D64, causal), within phase 6's tolerances, timed with their
    bounds and the SDPA yardsticks."""
    dev = torch.device("cuda")
    H, D, B = TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"], 8
    for T in (256, 512):
        rs = np.random.RandomState(T)
        q, k, v, do = (torch.from_numpy(rs.randn(B, T, H, D).astype(
            np.float32)).to(dev) for _ in range(4))
        out, lse = kernels.flash_attention_fwd(q, k, v, True)
        ref, ref_lse = kernels.flash_attention_fwd_plain(q, k, v, True)
        delta = kernels.flash_delta(ref, do)
        dq = kernels.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta,
                                            True)
        dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, ref_lse,
                                                 delta, True)
        refs = kernels.flash_attention_bwd_plain(q, k, v, ref, ref_lse, do,
                                                 True)
        errs = {"out": (out - ref).abs().max().item(),
                "lse": (lse - ref_lse).abs().max().item()}
        tols = {"out": 1e-5, "lse": 1e-5}
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            errs[name] = (got - want).abs().max().item()
            tols[name] = 1e-4 * max(1.0, want.abs().max().item())
        tag = "B%d T%d H%d D%d causal" % (B, T, H, D)
        log("flash %s: max_abs_err %s (phase 6's tolerances)"
            % (tag, ", ".join("%s=%.3g/%.3g" % (n, errs[n], tols[n])
                              for n in errs)))
        check(all(errs[n] <= tols[n] for n in errs),
              "flash kernels disagree with their plain versions at %s" % tag)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_fwd = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        lib_bwd = timer(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), do.transpose(1, 2).contiguous(),
            retain_graph=True))
        rows = (("flash_attention_fwd", (4, 3, 1, 1),
                 lambda: kernels.flash_attention_fwd(q, k, v, True),
                 lambda: kernels.flash_attention_fwd_plain(q, k, v, True),
                 lib_fwd),
                ("flash_attention_bwd_dq", (6, 4, 1, 2),
                 lambda: kernels.flash_attention_bwd_dq(
                     q, k, v, do, ref_lse, delta, True),
                 lambda: kernels.flash_attention_bwd_dq_plain(
                     q, k, v, do, ref_lse, delta, True), lib_bwd),
                ("flash_attention_bwd_dkv", (8, 4, 2, 2),
                 lambda: kernels.flash_attention_bwd_dkv(
                     q, k, v, do, ref_lse, delta, True),
                 lambda: kernels.flash_attention_bwd_dkv_plain(
                     q, k, v, do, ref_lse, delta, True), lib_bwd))
        for name, cost, fn, plain, lib in rows:
            b, by, tc = flash_bound(B, T, T, H, D, True, *cost)
            log("  %-24s %s f32: ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
                "bound_tc_ms=%.4f library_ms=%.4f (SDPA %s) [%s]"
                % (name, tag, timer(fn), timer(plain), b, by, tc, lib,
                   "forward" if name.endswith("fwd") else
                   "backward, dQ, dK and dV together", card))
        del qt, kt, vt, lib_out


def small_bucket_fit(torch, mx, block, dev):
    """Two epochs of the small bucketed LM through KVStore("device") on
    ``dev``; returns (initial, final) parameters on the host."""
    cfg = BUCKET_SMALL
    buckets = [16, 32, 64]
    it = bucket_iter(mx, bucket_sentences(cfg["vocab_size"], 8, buckets, 3),
                     4, buckets, 5)
    ctx = mx.gpu() if dev == "cuda" else mx.cpu()
    mod = mx.mod.BucketingModule(
        bucket_sym_gen(mx.sym, block, flash_min_seq=16, **cfg),
        default_bucket_key=it.default_bucket_key, context=ctx)
    mx.random.seed(0)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(initializer=mx.init.Xavier())
    start = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    mod.fit(it, kvstore=mx.kv.create("device", device=dev),
            optimizer="sgd", optimizer_params={"learning_rate": BUCKET_LR,
                                               "momentum": 0.9},
            eval_metric=mx.metric.Perplexity(ignore_label=0), num_epoch=2)
    return start, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def phase_bucketing_parity(torch, mx, kernels, block, card):
    """30a: the small bucketed LM card vs CPU."""
    kernels.reset_launches()
    start, card_p = small_bucket_fit(torch, mx, block, "cuda")
    got = dict(kernels.LAUNCHES)
    _, cpu_p = small_bucket_fit(torch, mx, block, "cpu")
    for key in FLASH_KEYS:
        check(got[key] > 0, "30a: %s never launched on the card" % key)
    worst = 0.0
    for name, want in cpu_p.items():
        update = np.abs(want - start[name]).max()
        err = np.abs(card_p[name] - want).max()
        if name.endswith("_k_bias"):
            # no gradient (phase 7): rounding noise within 1e-3 of the
            # key weight's largest update
            ref = np.abs(cpu_p[name[:-4] + "weight"]
                         - start[name[:-4] + "weight"]).max()
            moved = max(np.abs(card_p[name] - start[name]).max(), update)
            check(moved <= 1e-3 * ref, "30a: %s moved by %.3g, limit %.3g"
                  % (name, moved, 1e-3 * ref))
            continue
        worst = max(worst, err / update)
        check(err <= 1e-3 * update,
              "30a: %s differs card vs CPU by %.3g, its largest update "
              "%.3g" % (name, err, update))
    log("30a bucketed LM (L%d h%d V%d, buckets 16/32/64, flash_min_seq 16, "
        "batch 4, 2 epochs of SGD lr %g momentum 0.9 through "
        "KVStore('device')): every parameter within %.3g of its largest "
        "update card vs CPU (tolerance 1e-3; the key biases, which get no "
        "gradient, within 1e-3 of the key weight's update); flash launches "
        "on the card %s [%s]"
        % (BUCKET_SMALL["num_layers"], BUCKET_SMALL["hidden"],
           BUCKET_SMALL["vocab_size"], BUCKET_LR, worst,
           {k: got[k] for k in FLASH_KEYS}, card))


def phase_bucketing_full(torch, mx, kernels, block, card):
    """30b: the full-width LM through BucketingModule.fit over buckets
    256/512/1024; returns (launches, module, a 1024 batch)."""
    cfg = BUCKET_FULL
    buckets = [256, 512, 1024]
    B = 8
    sentences = bucket_sentences(cfg["vocab_size"], 32, buckets, 0)
    it = bucket_iter(mx, sentences, B, buckets, 0)
    mod = mx.mod.BucketingModule(
        bucket_sym_gen(mx.sym, block, flash_min_seq=256, **cfg),
        default_bucket_key=it.default_bucket_key)
    switch_ms, spawn_ms = [], []
    orig_switch = mod.switch_bucket

    def timed_switch(key, *a, **kw):
        fresh = key not in mod._buckets
        t0 = time.perf_counter()
        orig_switch(key, *a, **kw)
        (spawn_ms if fresh else switch_ms).append(
            (time.perf_counter() - t0) * 1e3)

    mod.switch_bucket = timed_switch
    ev, keys, real, ppl = [], [], [], []

    def on_batch(p):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append((p.epoch, e))
        keys.append(mod._curr_bucket_key)
        real.append(int(np.count_nonzero(
            p.locals["batch"].data[0].asnumpy())))
        if p.nbatch == len(it.idx) - 1:
            ppl.append(p.eval_metric.get()[1])

    mx.random.seed(0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t_fit = time.perf_counter()
    mod.fit(it, kvstore=mx.kv.create("device"), optimizer="sgd",
            optimizer_params={"learning_rate": BUCKET_LR, "momentum": 0.9},
            initializer=mx.init.Xavier(),
            eval_metric=mx.metric.Perplexity(ignore_label=0),
            batch_end_callback=on_batch, num_epoch=2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = len(ev)
    check(steps == 2 * len(it.idx), "30b ran %d steps, want %d"
          % (steps, 2 * len(it.idx)))
    for key in FLASH_KEYS:
        check(got[key] == cfg["num_layers"] * steps,
              "30b: %s launched %d times over %d steps, want %d"
              % (key, got[key], steps, cfg["num_layers"] * steps))
    # per bucket: the steps inside an epoch, without each bucket's first
    seen, per = set(), {b: [] for b in buckets}
    for i in range(steps):
        if keys[i] not in seen:
            seen.add(keys[i])
            continue
        if i == 0 or ev[i - 1][0] != ev[i][0]:
            continue
        per[keys[i]].append((ev[i - 1][1].elapsed_time(ev[i][1]), real[i]))
    n_params = sum(int(np.prod(a.shape))
                   for a in mod.get_params()[0].values())
    log("30b BucketingModule.fit L%d h%d V%d f32, buckets %s, "
        "flash_min_seq 256, batch %d, %d sentences, %.1f M parameters, SGD "
        "lr %g momentum 0.9 through KVStore('device'): %d steps in %.1f s"
        % (cfg["num_layers"], cfg["hidden"], cfg["vocab_size"], buckets, B,
           len(sentences), n_params / 1e6, BUCKET_LR, steps, fit_s))
    for b in buckets:
        ms = [m for m, _ in per[b]]
        check(ms, "30b: no timed step of bucket %d" % b)
        med = statistics.median(ms)
        toks = statistics.median([r for _, r in per[b]])
        log("  bucket %4d: %d timed steps, median %.3f ms per step "
            "(spread %.3f-%.3f): %.0f real tokens/s (median %d real of "
            "%d), %.0f padded tokens/s [%s]"
            % (b, len(ms), med, min(ms), max(ms), toks / med * 1e3, toks,
               B * b, B * b / med * 1e3, card))
    log("  host ms in switch_bucket: %.4f median over %d switches to a "
        "bound bucket (max %.4f); binding a new bucket: %s ms"
        % (statistics.median(switch_ms), len(switch_ms), max(switch_ms),
           ", ".join("%.1f" % x for x in spawn_ms)))
    log("  perplexity per epoch (ignore_label 0): %s; peak memory "
        "allocated %.2f GB [%s]"
        % (", ".join("%.2f" % x for x in ppl), peak / 1e9, card))
    check(len(ppl) == 2 and np.isfinite(ppl).all() and ppl[1] < ppl[0],
          "30b: the perplexity did not fall (%s)" % ppl)
    anchor = mod._buckets[it.default_bucket_key]._exec_group.execs[0]
    for b, child in mod._buckets.items():
        ex = child._exec_group.execs[0]
        for name in child._exec_group.param_names:
            for table in ("arg_dict", "grad_dict"):
                a = getattr(ex, table)[name]._handle
                want = getattr(anchor, table)[name]._handle
                check(a.data_ptr() == want.data_ptr(),
                      "30b: bucket %d's %s %s is not the anchor's storage"
                      % (b, table, name))
    log("  every bucket's %d parameter and gradient tensors are the "
        "anchor's (data_ptr)" % len(anchor.arg_dict))
    # one profiled step of the 1024 bucket
    it.reset()
    batch = next(b for b in it if b.bucket_key == 1024)
    from torch.profiler import ProfilerActivity, profile
    mod.forward_backward(batch)
    mod.update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(us for us, _ in device_by_kernel(prof).values()) / 1e3
    log("  profiled 1024 step: device busy %s of %.1f ms, idle share %s "
        "[%s]" % ("%.1f ms" % busy if busy else "not measured", wall,
                  "%.3f" % (1 - busy / wall) if busy else "not measured",
                  card))
    return got, mod, batch


# MXNET_TPU_FLASH_BWD=remat differentiates another formula in f32 (the
# einsum softmax's autograd backward, not the flash kernels' lse-based
# one): where the trained LM's softmax saturates, dS = P (dP - delta)
# cancels, and the two roundings leave the q and k weight gradients up to
# ~2.4e-2 of their largest magnitude apart on an H100 (PERF.md §6).
# flash_bwd_vs_f64 shows both formulas' distance from float64 at such
# inputs.  The four remat policies recompute with the same kernels and
# are held to 1e-5.
REMAT_BWD_TOL = 5e-2


def flash_bwd_vs_f64(torch, kernels, card):
    """dQ, dK, dV of causal attention at B2 T1024 H12 D64 from the flash
    kernels (B1 + B2a/B2b) and from the einsum formulation's autograd in
    f32, each against the same autograd in float64, as the softmax
    sharpens (q scaled by 1, 8 and 32)."""
    from mxnet_tpu_torch.ops.nn import _attention_einsum
    B, T, H, D = 2, 1024, TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"]
    scale = 1.0 / D ** 0.5
    for sharp in (1, 8, 32):
        rs = np.random.RandomState(sharp)
        q, k, v, do = (torch.from_numpy(rs.randn(B, T, H, D).astype(
            np.float32)).cuda() for _ in range(4))
        q = q * sharp
        out, lse = kernels.flash_attention_fwd(q, k, v, True)
        kern = kernels.flash_attention_bwd(q, k, v, out, lse, do, True)

        def autograd(dtype):
            x = [t.to(dtype).requires_grad_() for t in (q, k, v)]
            o = _attention_einsum(*x, True, scale)
            return torch.autograd.grad(o, x, do.to(dtype))
        f32, f64 = autograd(torch.float32), autograd(torch.float64)
        errs = []
        for name, a, b, t in zip(("dq", "dk", "dv"), kern, f32, f64):
            m = t.abs().max().item()
            errs.append("%s kernels %.3g einsum %.3g" % (
                name, (a.double() - t).abs().max().item() / m,
                (b.double() - t).abs().max().item() / m))
        log("30c flash backward vs float64, q x %d: %s (of each tensor's "
            "largest magnitude) [%s]" % (sharp, "; ".join(errs), card))


def phase_remat(torch, mx, kernels, mod, batch, card):
    """30c: one forward_backward of the 1024 bucket from one state under
    each remat policy and under MXNET_TPU_FLASH_BWD=remat, gradients held
    to the 'none' run's."""
    from mxnet_tpu_torch.executor import set_backward_mirror
    from mxnet_tpu_torch.ops import nn as ops_nn
    ex = mod._buckets[1024]._exec_group.execs[0]
    names = mod._buckets[1024]._exec_group.param_names
    runs = [("none", "pallas"), ("dots", "pallas"),
            ("dots_no_batch", "pallas"), ("full", "pallas"),
            ("none", "remat")]
    base, peaks = None, {}
    try:
        for policy, bwd in runs:
            set_backward_mirror(policy)
            ops_nn._FLASH_BWD = bwd
            mod.forward_backward(batch)        # warm: the first run of a
            torch.cuda.synchronize()           # policy loads its modules
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            mod.forward_backward(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            got = {k: kernels.LAUNCHES[k] for k in FLASH_KEYS}
            grads = {n: ex.grad_dict[n]._handle for n in names}
            tag = policy if bwd == "pallas" else "MXNET_TPU_FLASH_BWD=remat"
            if base is None:
                base = {n: g.clone() for n, g in grads.items()}
                gap = 0.0
            else:
                # the key biases get no gradient (phase 7): their rounding
                # noise is held to the key weight's largest magnitude
                gaps = sorted((((grads[n] - base[n]).abs().max() / base[
                    n[:-4] + "weight" if n.endswith("_k_bias") else n]
                    .abs().max().clamp_min(1e-30)).item(), n) for n in names)
                gap = gaps[-1][0]
                norm = max(((grads[n] - base[n]).norm() / base[n].norm()
                            .clamp_min(1e-30)).item() for n in names
                           if not n.endswith("_k_bias"))
                tol = 1e-5 if bwd == "pallas" else REMAT_BWD_TOL
                log("30c %s: the largest gaps %s; the largest norm-wise "
                    "gap %.3g" % (tag, ", ".join("%s %.3g" % (n, g)
                                                for g, n in gaps[-4:]),
                                  norm))
                check(gap <= tol, "30c: %s gradients differ from 'none' "
                      "by %.3g of a tensor's largest magnitude (tolerance "
                      "%g)" % (tag, gap, tol))
            peaks[tag] = peak
            log("30c %-26s forward_backward %.1f ms (after a warm run), "
                "peak memory %.3f GB, largest gradient gap to 'none' %.3g "
                "(of each tensor's largest magnitude, the key biases' of "
                "the key weight's; tolerance 1e-5), launches %s [%s]"
                % (tag, ms, peak / 1e9, gap, got, card))
    finally:
        set_backward_mirror(None)
        ops_nn._FLASH_BWD = "pallas"
    check(peaks["full"] < peaks["none"],
          "30c: full's peak %.3f GB is not below none's %.3f GB"
          % (peaks["full"] / 1e9, peaks["none"] / 1e9))
    flash_bwd_vs_f64(torch, kernels, card)


def phase_bucketing(torch, mx, kernels, F, card):
    """Phase 30: the flash kernels at T 256 and 512, then 30a-30c;
    returns the launches of 30b, the main path."""
    from mxnet_tpu_torch.models.transformer import _block
    timer = Timer(torch)
    flash_at_lengths(torch, kernels, F, timer, card)
    del timer
    phase_bucketing_parity(torch, mx, kernels, _block, card)
    got, mod, batch = phase_bucketing_full(torch, mx, kernels, _block, card)
    phase_remat(torch, mx, kernels, mod, batch, card)
    del mod, batch
    torch.cuda.empty_cache()
    return got


# -- phase 31: autograd and Gluon ---------------------------------------------

FLASH_KEYS = ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")


def gluon_flash(torch, mx, kernels, card, shape=(8, 1024, 12, 64),
                dev="cuda"):
    """31a: ``nd.contrib.fused_attention`` under ``autograd.record`` with
    q, k and v marked, then with only q marked: the output and the marked
    gradients against autograd through the plain einsum formulation on
    the same device (phase 6's tolerances), one launch each of B1, B2a
    and B2b per recording.  Returns the launches of both."""
    from mxnet_tpu_torch.ops.nn import _attention_einsum
    ctx = mx.gpu(0) if dev == "cuda" else mx.cpu()
    rs = np.random.RandomState(31)
    host = [rs.randn(*shape).astype(np.float32) for _ in range(4)]
    scale = 1.0 / float(shape[-1]) ** 0.5
    t = [torch.from_numpy(a).to(dev).requires_grad_() for a in host[:3]]
    ref = _attention_einsum(*t, True, scale)
    want = dict(zip("qkv", torch.autograd.grad(
        ref, t, torch.from_numpy(host[3]).to(dev))))
    ref = ref.detach()
    del t
    total = {}
    for marked in ("qkv", "q"):
        q, k, v, do = [mx.nd.array(a, ctx=ctx) for a in host]
        named = dict(q=q, k=k, v=v)
        if marked == "qkv":
            for n in marked:
                named[n].attach_grad()
            bufs = [named[n].grad for n in marked]
        else:
            bufs = [mx.nd.zeros(q.shape, ctx=ctx)]
            mx.autograd.mark_variables([q], bufs)
        kernels.reset_launches()
        with mx.autograd.record():
            o = mx.nd.contrib.fused_attention(q, k, v, causal=True)
        o.backward(do)
        if dev == "cuda":
            torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        for key in FLASH_KEYS:
            total[key] = total.get(key, 0) + got.get(key, 0)
        errs = {"out": (o._handle - ref).abs().max().item()}
        tols = {"out": 1e-5}
        for n, buf in zip(marked, bufs):
            errs["d" + n] = (buf._handle - want[n]).abs().max().item()
            tols["d" + n] = 1e-4 * max(1.0, want[n].abs().max().item())
        log("31a fused_attention under autograd.record, %s marked, (B, T, "
            "H, D) = %s f32: max_abs_err %s against autograd of the einsum "
            "(tolerances: out 1e-5 absolute, gradients 1e-4 x max(1, "
            "max|ref|), phase 6's); launches %s [%s]"
            % (marked, shape, ", ".join("%s=%.3g/%.3g" % (n, errs[n], tols[n])
                                        for n in errs),
               {k: got.get(k, 0) for k in FLASH_KEYS}, card))
        check(all(errs[n] <= tols[n] for n in errs),
              "31a: fused_attention under autograd disagrees with the "
              "plain formulation (%s marked)" % marked)
        if dev == "cuda":
            for key in FLASH_KEYS:
                check(got.get(key, 0) == 1, "31a: %s launched %d times, "
                      "want 1 (%s marked)" % (key, got.get(key, 0), marked))
        del q, k, v, do, o, bufs, named
    return total


def gluon_lm_block(mx, cfg):
    """The LM's logits (N, T, vocab) as a SymbolBlock over ``data``."""
    from mxnet_tpu_torch.models.transformer import get_symbol
    net = get_symbol(**cfg).get_internals()["head_output"]
    return mx.gluon.SymbolBlock(net, mx.sym.var("data"))


def gluon_step(mx, net, trainer, loss_fn, x, y, batch):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch)
    return loss


GLUON_LM_SMALL = dict(vocab_size=1000, seq_len=1024, num_layers=2,
                      hidden=128, heads=2)


def gluon_lm_parity(torch, mx, kernels, convert, card, cfg=GLUON_LM_SMALL,
                    batch=2):
    """31b, card against CPU: one SymbolBlock + Trainer step of the small
    LM (T 1024, so the card's attention runs the flash kernels) from one
    seeded start, each parameter's update within 1e-3 of its largest
    change and the loss within 1e-4; then the card's gradients under
    ``set_backward_mirror("dots")`` against ``none``'s."""
    T = cfg["seq_len"]
    batch_np = lm_batch(cfg["vocab_size"], batch, T, seed=17)
    mx.random.seed(3)
    with mx.cpu():
        start = gluon_lm_block(mx, cfg)
        start.collect_params().initialize(mx.init.Xavier(), ctx=mx.cpu())
        start.infer_shape(mx.nd.array(batch_np["data"]))
        for p in start.collect_params().values():
            p._finish_deferred_init()
    arrays = {k: p.data().asnumpy()
              for k, p in start.collect_params().items()}
    del start
    result = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        net = gluon_lm_block(mx, cfg)
        convert.gluon_params_from_numpy(net.collect_params(), arrays,
                                        ctx=ctx)
        net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.01, "momentum": 0.9},
                                   kvstore="device")
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        x = mx.nd.array(batch_np["data"], ctx=ctx)
        y = mx.nd.array(batch_np["softmax_label"], ctx=ctx)
        t0 = time.perf_counter()
        loss = gluon_step(mx, net, trainer, loss_fn, x, y, batch)
        loss = float(loss.asnumpy().mean())
        dt = time.perf_counter() - t0
        result[ctx.device_type] = (
            {k: p.data().asnumpy() - arrays[k]
             for k, p in net.collect_params().items()}, loss, dt)
        log("31b SymbolBlock + Trainer step %s L%d h%d T%d V%d batch %d: "
            "%.2f s, loss %.6f" % (ctx, cfg["num_layers"], cfg["hidden"], T,
                                   cfg["vocab_size"], batch, dt, loss))
    worst = k_worst = 0.0
    for name, want in result["cpu"][0].items():
        got = result["gpu"][0][name]
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if name.endswith("_k_bias"):
            # no gradient (the softmax ignores a per-row shift): both are
            # rounding noise of zero, held to the key weight's update
            limit = 1e-3 * float(np.abs(result["cpu"][0][
                name[:-len("bias")] + "weight"]).max())
            check(max(scale, float(np.abs(got).max())) <= limit,
                  "31b: %s moved by more than %.3g" % (name, limit))
            continue
        if name.endswith("_k_weight"):
            # the same shift invariance: the key rows' gradients sum to
            # zero per head, so the key weight's gradient is what is left
            # of a sum over B*T rows of dK that cancels, and the dK/dV
            # kernel's rounding (within phase 6's tolerance) stays whole
            # in it.  Held norm-wise, as phase 18 holds its ill-
            # conditioned tensors: within 1e-3 of the update's norm.
            nerr = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            k_worst = max(k_worst, nerr)
            log("31b %s: max_abs_err %.3g of its largest update, norm-wise "
                "%.3g" % (name, err / scale, nerr))
            check(nerr <= 1e-3, "31b: update of %s on the card differs "
                  "from the CPU norm-wise by %.3g (tolerance 1e-3)"
                  % (name, nerr))
            continue
        worst = max(worst, err / scale)
        check(err <= 1e-3 * scale, "31b: update of %s on the card differs "
              "from the CPU by %.3g, its largest update is %.3g"
              % (name, err, scale))
    lc, lh = result["gpu"][1], result["cpu"][1]
    log("31b step card vs cpu: updates agree per tensor within %.3g of its "
        "largest update (tolerance 1e-3, as phase 7; the key weights "
        "norm-wise within %.3g, tolerance 1e-3; the key biases, whose "
        "gradient is zero, within 1e-3 of the key weight's); "
        "loss %.6f vs %.6f (tolerance 1e-4 relative) [%s]"
        % (worst, k_worst, lc, lh, card))
    check(abs(lc - lh) <= 1e-4 * abs(lh), "31b: loss on the card differs "
          "from the CPU")
    # remat (set_backward_mirror) applies to a hybridized block: same
    # gradients
    net = gluon_lm_block(mx, cfg)
    convert.gluon_params_from_numpy(net.collect_params(), arrays,
                                    ctx=mx.gpu(0))
    net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x = mx.nd.array(batch_np["data"], ctx=mx.gpu(0))
    y = mx.nd.array(batch_np["softmax_label"], ctx=mx.gpu(0))
    grads, peaks = {}, {}
    try:
        for policy in ("none", "dots"):
            mx.set_backward_mirror(policy)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            del loss
            torch.cuda.synchronize()
            peaks[policy] = torch.cuda.max_memory_allocated()
            grads[policy] = {k: p.grad().asnumpy()
                             for k, p in net.collect_params().items()}
    finally:
        mx.set_backward_mirror(None)
    gap = max(float(np.abs(grads["dots"][k] - g).max()) /
              max(float(np.abs(g).max()), 1e-30)
              for k, g in grads["none"].items())
    log("31b remat on the hybridized block: 'dots' gradients within %.3g "
        "of 'none''s relative to each tensor's largest (tolerance 1e-5); "
        "peak %.3f GB vs %.3f GB [%s]" % (gap, peaks["dots"] / 1e9,
                                          peaks["none"] / 1e9, card))
    check(gap <= 1e-5, "31b: remat changed the hybridized block's "
          "gradients")


def gluon_lm_full(torch, mx, kernels, get_symbol, ShardedTrainer,
                  trainer_ms, card, warm=2, timed=10):
    """31b at full width: the LM's logits as a hybridized SymbolBlock with
    phase 8's weights (``init_state(seed=0)``), SoftmaxCrossEntropyLoss
    and ``gluon.Trainer("sgd", kvstore="device")`` at batch 8; returns the
    launches of the timed loop."""
    cfg = TRAIN
    B, T, L = 8, cfg["seq_len"], cfg["num_layers"]
    tr = ShardedTrainer(get_symbol(**cfg), lr=1e-4, momentum=0.9, wd=0.0)
    params, _mom, _aux = tr.init_state({"data": (B, T),
                                        "softmax_label": (B, T)}, seed=0)
    net = gluon_lm_block(mx, cfg)
    pd = net.collect_params()
    for name, t in zip(tr.param_names, params):
        pd[name]._load_init(mx.nd.NDArray(t), mx.gpu(0))
    del tr, params, _mom
    check(all(p._data is not None for p in pd.values()),
          "31b: a parameter of the SymbolBlock got no weight")
    net.hybridize()
    trainer = mx.gluon.Trainer(pd, "sgd", {"learning_rate": 1e-4,
                                           "momentum": 0.9},
                               kvstore="device")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    batch = lm_batch(cfg["vocab_size"], B, T, seed=0)
    x = mx.nd.array(batch["data"], ctx=mx.gpu(0))
    y = mx.nd.array(batch["softmax_label"], ctx=mx.gpu(0))

    def ce():
        return float(loss_fn(net(x), y).asnumpy().mean())

    ce0 = ce()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    ends = [torch.cuda.Event(enable_timing=True)
            for _ in range(warm + timed + 1)]
    step_host = []
    ends[0].record()
    for i in range(warm + timed):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        t0 = time.perf_counter()
        trainer.step(B)
        step_host.append((time.perf_counter() - t0) * 1e3)
        del loss
        ends[i + 1].record()
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    steps = warm + timed
    peak = torch.cuda.max_memory_allocated()
    ms = [ends[i].elapsed_time(ends[i + 1]) for i in range(warm, steps)]
    med = statistics.median(ms)
    # the same loop with the loss kept until the next one is made: the
    # graph kept for a second backward lives as long as the loss does
    torch.cuda.reset_peak_memory_stats()
    loss = None
    for _ in range(2):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(B)
    torch.cuda.synchronize()
    peak_kept = torch.cuda.max_memory_allocated()
    del loss
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gluon_step(mx, net, trainer, loss_fn, x, y, B)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_by_kernel(prof)
    busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
    ce1 = ce()
    log("31b launches over %d Gluon steps: %s" % (steps, {
        k: got.get(k, 0) for k in FLASH_KEYS}))
    for key in FLASH_KEYS:
        check(got.get(key, 0) == L * steps, "31b: %s launched %d times "
              "over %d steps, want %d" % (key, got.get(key, 0), steps,
                                           L * steps))
    log("31b Gluon LM L%d h%d V%d T%d batch %d f32 (SymbolBlock, "
        "hybridized; autograd.record, backward, Trainer.step, kvstore "
        "'device'): timed %s ms; median %.1f ms (spread %.1f-%.1f) = %.0f "
        "tokens/s; ShardedTrainer.step %.1f ms (%.0f tokens/s, phase 8); "
        "host ms in Trainer.step (%d per-key updates) median %.1f; "
        "device busy %s of the profiled step's %.1f ms (idle share %s); "
        "peak memory %.2f GB with the loss freed each step, %.2f GB with "
        "it kept until the next; cross-entropy of the repeated batch %.4f "
        "-> %.4f after %d steps [%s]"
        % (L, cfg["hidden"], cfg["vocab_size"], T, B,
           ", ".join("%.1f" % m for m in ms), med, min(ms), max(ms),
           B * T / med * 1e3, trainer_ms, B * T / trainer_ms * 1e3,
           len(pd), statistics.median(step_host[warm:]),
           "%.1f ms" % busy_ms if by_kernel else "not measured", prof_ms,
           "%.3f" % (1 - busy_ms / prof_ms) if by_kernel else
           "not measured", peak / 1e9, peak_kept / 1e9, ce0, ce1,
           steps + 3, card))
    check(np.isfinite(ce0) and np.isfinite(ce1) and ce1 < ce0,
          "31b: the cross-entropy of the repeated batch did not fall "
          "(%.4f -> %.4f)" % (ce0, ce1))
    return got


def gluon_resnet_parity(torch, mx, convert, card):
    """31c, card against CPU: one hybridized ``resnet18_v1`` step (32x32,
    batch 4, SoftmaxCrossEntropyLoss, SGD momentum 0.9, wd 1e-4) from one
    seeded start; the updates norm-wise within 1e-2 (phase 18's
    tolerance for the 7x7 stem and max pool, where a ReLU or max-pool
    tie can go another way on the two devices), the loss within 1e-4."""
    rs = np.random.RandomState(19)
    X = rs.randn(4, 3, 32, 32).astype(np.float32)
    Y = rs.randint(0, 10, 4).astype(np.float32)
    mx.random.seed(4)
    with mx.cpu():
        with mx.name.NameManager():
            start = mx.gluon.model_zoo.vision.resnet18_v1(classes=10)
        start.initialize(mx.init.Xavier(), ctx=mx.cpu())
        start(mx.nd.array(X))
    arrays = {k: p.data().asnumpy() for k, p in
              start.collect_params().items()}
    del start
    upd, losses = {}, {}
    for ctx in (mx.gpu(0), mx.cpu()):
        with mx.name.NameManager():
            net = mx.gluon.model_zoo.vision.resnet18_v1(classes=10)
        convert.gluon_params_from_numpy(net.collect_params(), arrays,
                                        ctx=ctx)
        net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9,
                                    "wd": 1e-4})
        loss = gluon_step(mx, net, trainer,
                          mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                          mx.nd.array(X, ctx=ctx), mx.nd.array(Y, ctx=ctx),
                          4)
        losses[ctx.device_type] = float(loss.asnumpy().mean())
        upd[ctx.device_type] = np.concatenate([
            (p.data().asnumpy() - arrays[k]).ravel()
            for k, p in net.collect_params().items()])
    gap = float(np.linalg.norm(upd["gpu"] - upd["cpu"]) /
                np.linalg.norm(upd["cpu"]))
    log("31c resnet18_v1 32x32 batch 4, one Gluon step card vs cpu: the "
        "updates norm-wise %.3g apart (tolerance 1e-2, phase 18's for the "
        "imagenet stem); loss %.6f vs %.6f (tolerance 1e-4 relative) [%s]"
        % (gap, losses["gpu"], losses["cpu"], card))
    check(gap <= 1e-2, "31c: resnet18_v1 step card vs cpu")
    check(abs(losses["gpu"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"]),
          "31c: resnet18_v1 loss card vs cpu")


def gluon_resnet50_net(mx, X):
    with mx.name.NameManager():
        net = mx.gluon.model_zoo.vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.hybridize()
    net(X)           # the deferred shapes, then the weights
    return net


def gluon_resnet50(torch, mx, card, warm=2, timed=5, batch=RESNET_BATCH):
    """31c at full width: ``resnet50_v1(classes=1000)`` hybridized at
    224x224, batch 32, f32 (cuDNN, TF32 off), SGD lr 0.1, momentum 0.9,
    wd 1e-4: images/s, idle share of a profiled step, peak memory; then
    the training check of phase 19 (RESNET_CHECK) on a fresh net."""
    torch.backends.cudnn.benchmark = True
    rs = np.random.RandomState(0)
    X = mx.nd.array(rs.randn(batch, 3, 224, 224).astype(np.float32),
                    ctx=mx.gpu(0))
    Y = mx.nd.array(rs.randint(0, 1000, batch).astype(np.float32),
                    ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    mx.random.seed(0)
    net = gluon_resnet50_net(mx, X)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-4})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ends = [torch.cuda.Event(enable_timing=True)
            for _ in range(warm + timed + 1)]
    ends[0].record()
    for i in range(warm + timed):
        gluon_step(mx, net, trainer, loss_fn, X, Y, batch)
        ends[i + 1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = [ends[i].elapsed_time(ends[i + 1])
          for i in range(warm, warm + timed)]
    med = statistics.median(ms)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gluon_step(mx, net, trainer, loss_fn, X, Y, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_by_kernel(prof)
    busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
    log("31c Gluon resnet50_v1 224x224 batch %d f32 (hybridized, cuDNN, "
        "TF32 off; Trainer sgd lr 0.1 momentum 0.9 wd 1e-4): timed %s ms; "
        "median %.1f ms = %.1f images/s; device busy %s of the profiled "
        "step's %.1f ms (idle share %s); peak memory %.2f GB [%s]"
        % (batch, ", ".join("%.1f" % m for m in ms), med,
           batch / med * 1e3,
           "%.1f ms" % busy_ms if by_kernel else "not measured", prof_ms,
           "%.3f" % (1 - busy_ms / prof_ms) if by_kernel else
           "not measured", peak / 1e9, card))
    del net, trainer
    torch.cuda.empty_cache()
    # the training check on a fresh net at RESNET_CHECK's lr (the lr 0.1
    # loop may spike by chance, ROADMAP / PERF.md)
    mx.random.seed(0)
    net = gluon_resnet50_net(mx, X)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": RESNET_CHECK["lr"],
                                "momentum": 0.9, "wd": 1e-4})
    ces = []
    for _ in range(RESNET_CHECK["steps"]):
        loss = gluon_step(mx, net, trainer, loss_fn, X, Y, batch)
        ces.append(float(loss.asnumpy().mean()))
        del loss
    with mx.autograd.train_mode():
        ces.append(float(loss_fn(net(X), Y).asnumpy().mean()))
    log("31c training check: a fresh net at lr %g, cross-entropy of the "
        "repeated batch by step (training-mode forwards) %s; must fall by "
        "%.1f [%s]" % (RESNET_CHECK["lr"], ", ".join("%.3f" % c
                                                     for c in ces),
                       RESNET_CHECK["margin"], card))
    check(np.all(np.isfinite(ces)) and
          ces[-1] <= ces[0] - RESNET_CHECK["margin"],
          "31c: the Gluon ResNet-50 did not learn the repeated batch")
    del net, trainer
    torch.cuda.empty_cache()
    return med


def phase_gluon(torch, mx, kernels, convert, get_symbol, ShardedTrainer,
                trainer_ms, card):
    """Phase 31: 31a-31c; returns the launches of 31a and of 31b's timed
    Gluon loop, the main path."""
    got_a = gluon_flash(torch, mx, kernels, card)
    torch.cuda.empty_cache()
    gluon_lm_parity(torch, mx, kernels, convert, card)
    torch.cuda.empty_cache()
    got_b = gluon_lm_full(torch, mx, kernels, get_symbol, ShardedTrainer,
                          trainer_ms, card)
    torch.cuda.empty_cache()
    gluon_resnet_parity(torch, mx, convert, card)
    gluon_resnet50(torch, mx, card)
    return got_a, got_b

# -- phases 32-33: the recurrent stack, linalg and the spatial ops ----------

# Zaremba et al. (2014)'s large LSTM word LM, the tied 1500-unit
# configuration of MXNet's example/gluon/word_language_model
WORD_LM = dict(vocab=10000, hidden=1500, layers=2, dropout=0.65, batch=32,
               bptt=35, clip=0.2, lr=1.0)


def word_lm_model(mx, vocab, hidden, layers, dropout):
    """example/gluon/word_language_model's RNNModel with tied weights:
    Embedding -> Dropout -> rnn.LSTM -> Dropout -> Dense on the encoder's
    weight."""
    gluon = mx.gluon

    class RNNModel(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(dropout)
                self.encoder = gluon.nn.Embedding(
                    vocab, hidden, weight_initializer=mx.init.Uniform(0.1))
                self.rnn = gluon.rnn.LSTM(hidden, layers, dropout=dropout,
                                          input_size=hidden)
                self.decoder = gluon.nn.Dense(vocab, in_units=hidden,
                                              params=self.encoder.params)

        def forward(self, inputs, state):
            emb = self.drop(self.encoder(inputs))
            output, state = self.rnn(emb, state)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, hidden))), state

    with mx.name.NameManager():
        return RNNModel()


def zipf_ids(vocab, n, seed):
    """``n`` token ids over ``vocab`` from a seed, with Zipf's unigram law
    (probability ~ 1 / rank), the shape of a word corpus's counts."""
    p = 1.0 / np.arange(1, vocab + 1)
    return np.random.RandomState(seed).choice(vocab, size=n, p=p / p.sum())


def word_lm_batches(vocab, bptt, batch, n, seed):
    """``n`` (data, target) pairs of (bptt, batch) ids: ``batch`` streams
    cut into bptt windows, as batchify and get_batch cut the corpus."""
    ids = zipf_ids(vocab, (n * bptt + 1) * batch, seed)
    ids = ids.reshape(batch, -1).T.astype(np.float32)
    return [(ids[i * bptt:(i + 1) * bptt], ids[i * bptt + 1:
                                                (i + 1) * bptt + 1])
            for i in range(n)]


def word_lm_step(mx, model, trainer, loss_fn, state, data, target, cfg):
    """One step of the example's train(): detach, record, backward,
    clip_global_norm(grads, clip * bptt * batch), Trainer.step(batch).
    Returns the batch's mean cross-entropy (an NDArray), the state and
    the host ms in ``Trainer.step``."""
    state = [s.detach() for s in state]
    with mx.autograd.record():
        out, state = model(data, state)
        L = loss_fn(out, target.reshape((-1,)))
    L.backward()
    mx.gluon.utils.clip_global_norm(
        [p.grad() for p in model.collect_params().values()],
        cfg["clip"] * cfg["bptt"] * cfg["batch"])
    t0 = time.perf_counter()
    trainer.step(cfg["batch"])
    return L.mean(), state, (time.perf_counter() - t0) * 1e3


def held_out_perplexity(mx, model, loss_fn, held, cfg, ctx):
    """exp of the mean cross-entropy of ``held`` (data, target) from an
    evaluation pass without ``record`` (no dropout), from zero states."""
    with ctx:
        state = model.rnn.begin_state(batch_size=cfg["batch"],
                                      func=mx.nd.zeros)
    out, _ = model(held[0], state)
    return float(np.exp(loss_fn(out, held[1].reshape((-1,))).mean()
                        .asscalar()))


def word_lm_trainer(mx, model, cfg):
    return mx.gluon.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": cfg["lr"], "momentum": 0,
                             "wd": 0})


def word_lm_parity(torch, mx, convert, card, cfg=WORD_LM):
    """32a-i: one step of the full-width word LM with dropout 0 on the
    card and on the CPU (plain loop) from the same weights: the loss, and
    each parameter's update norm-wise."""
    c = dict(cfg, dropout=0.0)
    data, target = word_lm_batches(c["vocab"], c["bptt"], c["batch"], 1,
                                   seed=320)[0]
    mx.random.seed(0)
    with mx.cpu():
        cpu_model = word_lm_model(mx, c["vocab"], c["hidden"], c["layers"],
                                  0.0)
        cpu_model.initialize(mx.init.Xavier(), ctx=mx.cpu())
    start = {k: p.data().asnumpy()
             for k, p in cpu_model.collect_params().items()}
    card_model = word_lm_model(mx, c["vocab"], c["hidden"], c["layers"],
                               0.0)
    convert.gluon_params_from_numpy(card_model.collect_params(), start,
                                    ctx=mx.gpu(0))
    res = {}
    for tag, model, ctx in (("card", card_model, mx.gpu(0)),
                            ("cpu", cpu_model, mx.cpu())):
        with ctx:
            state = model.rnn.begin_state(batch_size=c["batch"],
                                          func=mx.nd.zeros)
            loss, _, _ = word_lm_step(
                mx, model, word_lm_trainer(mx, model, c), mx.gluon.loss.
                SoftmaxCrossEntropyLoss(), state, mx.nd.array(data),
                mx.nd.array(target), c)
            res[tag] = (float(loss.asscalar()), {
                k: p.data().asnumpy()
                for k, p in model.collect_params().items()})
    (l_card, p_card), (l_cpu, p_cpu) = res["card"], res["cpu"]
    gaps = {}
    for k, w0 in start.items():
        upd = p_cpu[k] - w0
        gaps[k] = float(np.linalg.norm(p_card[k] - p_cpu[k])
                        / max(np.linalg.norm(upd), 1e-30))
    worst = max(gaps, key=gaps.get)
    log("32a word LM step card vs cpu (V%d h%d L%d, T%d batch %d, dropout "
        "0, same weights): loss %.6f / %.6f (rel %.2e, tolerance 1e-5); "
        "each parameter's update norm-wise: worst %s %.2e (tolerance "
        "1e-3), all %s [%s]"
        % (c["vocab"], c["hidden"], c["layers"], c["bptt"], c["batch"],
           l_card, l_cpu, abs(l_card - l_cpu) / abs(l_cpu), worst,
           gaps[worst], ", ".join("%s=%.1e" % kv for kv in
                                  sorted(gaps.items())), card))
    check(abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu),
          "32a: the word LM's loss on the card is %.6f, on the CPU %.6f"
          % (l_card, l_cpu))
    check(gaps[worst] <= 1e-3, "32a: %s's update on the card stands %.2e "
          "of its norm from the CPU's" % (worst, gaps[worst]))


def op_device_ms(prof, names):
    """Device ms of the torch ops named ``names`` (their kernels, children
    included) in a torch.profiler run."""
    total = 0.0
    for ev in prof.key_averages():
        if ev.key in names:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0)
            total += us
    return total / 1e3


def word_lm_full(torch, mx, card, cfg=WORD_LM, warm=3, timed=20):
    """32a-ii: the word LM at full width with dropout 0.65 on the card:
    3 warm-up and 20 timed steps (CUDA events at each step's end), the
    held-out batch's perplexity before and after, one profiled step.
    Returns the cuDNN calls of the timed loop."""
    from mxnet_tpu_torch.ops import rnn as trnn
    c = cfg
    ctx = mx.gpu(0)
    mx.random.seed(1)
    model = word_lm_model(mx, c["vocab"], c["hidden"], c["layers"],
                          c["dropout"])
    model.initialize(mx.init.Xavier(), ctx=ctx)
    n_params = sum(int(np.prod(p.shape))
                   for p in model.collect_params().values())
    trainer = word_lm_trainer(mx, model, c)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    batches = [(mx.nd.array(d, ctx=ctx), mx.nd.array(t, ctx=ctx))
               for d, t in word_lm_batches(c["vocab"], c["bptt"],
                                           c["batch"], warm + timed + 1,
                                           seed=321)]
    held = [(mx.nd.array(d, ctx=ctx), mx.nd.array(t, ctx=ctx))
            for d, t in word_lm_batches(c["vocab"], c["bptt"], c["batch"],
                                        1, seed=322)][0]
    ppl0 = held_out_perplexity(mx, model, loss_fn, held, c, ctx)
    with ctx:
        state = model.rnn.begin_state(batch_size=c["batch"],
                                      func=mx.nd.zeros)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trnn.CALLS.update(cudnn=0, plain=0)
    ends = [torch.cuda.Event(enable_timing=True)
            for _ in range(warm + timed + 1)]
    losses, step_host = [], []
    ends[0].record()
    for i in range(warm + timed):
        loss, state, host = word_lm_step(mx, model, trainer, loss_fn, state,
                                         *batches[i], c)
        losses.append(loss)
        step_host.append(host)
        ends[i + 1].record()
    torch.cuda.synchronize()
    calls = dict(trnn.CALLS)
    peak = torch.cuda.max_memory_allocated()
    steps = warm + timed
    ms = [ends[i].elapsed_time(ends[i + 1]) for i in range(warm, steps)]
    med = statistics.median(ms)
    ce = [float(x.asscalar()) for x in losses]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, state, _ = word_lm_step(mx, model, trainer, loss_fn, state,
                                   *batches[-1], c)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_by_kernel(prof)
    busy_ms = sum(us for us, _ in by_kernel.values()) / 1e3
    rnn_ms = op_device_ms(prof, ("aten::_cudnn_rnn",
                                 "aten::_cudnn_rnn_backward"))
    cat_ms = op_device_ms(prof, ("aten::cat",))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    ppl1 = held_out_perplexity(mx, model, loss_fn, held, c, ctx)
    tokens = c["bptt"] * c["batch"]
    log("32a word LM (Zaremba large, tied: V%d, 2 x LSTM %d, dropout "
        "%.2f, %.1f M parameters) T%d batch %d f32 through Gluon "
        "(autograd.record, backward, clip_global_norm, Trainer.step, SGD "
        "lr %.1f): timed %s ms; median %.2f ms (spread %.2f-%.2f) = %.0f "
        "tokens/s; host ms in Trainer.step median %.2f; device busy %s "
        "of the profiled step's %.2f ms (idle share %s); cuDNN's RNN "
        "(aten::_cudnn_rnn + _backward, their kernels) %.2f ms of the "
        "busy time; aten::cat %.3f ms; top kernels %s; peak memory %.2f "
        "GB; cuDNN calls %d, plain loops %d [%s]"
        % (c["vocab"], c["hidden"], c["dropout"], n_params / 1e6,
           c["bptt"], c["batch"], c["lr"], ", ".join("%.1f" % m for m in ms),
           med, min(ms), max(ms), tokens / med * 1e3,
           statistics.median(step_host[warm:]),
           "%.2f ms" % busy_ms if by_kernel else "not measured", prof_ms,
           "%.3f" % (1 - busy_ms / prof_ms) if by_kernel else
           "not measured", rnn_ms, cat_ms,
           "; ".join("%s %.2f ms" % (k[:60], us / 1e3)
                     for k, (us, _) in top),
           peak / 1e9, calls["cudnn"], calls["plain"], card))
    log("32a cross-entropy per step at lr %.1f: %s; held-out perplexity "
        "(an evaluation pass without record) %.1f -> %.1f [%s]"
        % (c["lr"], ", ".join("%.3f" % x for x in ce), ppl0, ppl1, card))
    check(calls["cudnn"] == steps and calls["plain"] == 0,
          "32a: the RNN op ran cuDNN %d and the plain loop %d times over %d "
          "steps" % (calls["cudnn"], calls["plain"], steps))
    check(all(np.isfinite(ce)) and np.isfinite(ppl0) and np.isfinite(ppl1),
          "32a: a non-finite loss or perplexity")
    return med


# the word LM's training check: a fresh model at this lr (lr 1.0 spikes
# at the third step at full width, on the CPU too, without dropout) must
# lower the cross-entropy of WORD_LM_CHECK_STEPS Zipf batches by the
# margin, and the held-out perplexity
WORD_LM_CHECK_LR = 0.1
WORD_LM_CHECK_STEPS = 10
WORD_LM_CE_MARGIN = 0.5


def word_lm_check(torch, mx, card, cfg=WORD_LM):
    """32a-iii: the training check (dropout 0.65 on)."""
    c = dict(cfg, lr=WORD_LM_CHECK_LR)
    ctx = mx.gpu(0)
    mx.random.seed(2)
    model = word_lm_model(mx, c["vocab"], c["hidden"], c["layers"],
                          c["dropout"])
    model.initialize(mx.init.Xavier(), ctx=ctx)
    trainer = word_lm_trainer(mx, model, c)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    held = [(mx.nd.array(d, ctx=ctx), mx.nd.array(t, ctx=ctx))
            for d, t in word_lm_batches(c["vocab"], c["bptt"], c["batch"],
                                        1, seed=322)][0]
    ppl0 = held_out_perplexity(mx, model, loss_fn, held, c, ctx)
    with ctx:
        state = model.rnn.begin_state(batch_size=c["batch"],
                                      func=mx.nd.zeros)
    ce = []
    for d, t in word_lm_batches(c["vocab"], c["bptt"], c["batch"],
                                WORD_LM_CHECK_STEPS, seed=326):
        loss, state, _ = word_lm_step(mx, model, trainer, loss_fn, state,
                                      mx.nd.array(d, ctx=ctx),
                                      mx.nd.array(t, ctx=ctx), c)
        ce.append(loss)
    ce = [float(x.asscalar()) for x in ce]
    ppl1 = held_out_perplexity(mx, model, loss_fn, held, c, ctx)
    last = float(np.mean(ce[-3:]))
    log("32a training check (a fresh model, dropout %.2f, lr %.1f, %d "
        "Zipf batches): cross-entropy %s (first %.3f, last three %.3f, "
        "margin %.1f); held-out perplexity %.1f -> %.1f [%s]"
        % (c["dropout"], c["lr"], WORD_LM_CHECK_STEPS,
           ", ".join("%.3f" % x for x in ce), ce[0], last,
           WORD_LM_CE_MARGIN, ppl0, ppl1, card))
    check(last < ce[0] - WORD_LM_CE_MARGIN and ppl1 < ppl0,
          "32a: the word LM did not learn (cross-entropy %.3f -> %.3f, "
          "held-out perplexity %.1f -> %.1f)" % (ce[0], last, ppl0, ppl1))


def word_lm_rnn_costs(torch, card, cfg=WORD_LM):
    """32a-iv: the LM's two LSTM layers alone at its shapes: the RNN op
    on the packed blob (cuDNN copies the blob's weights into its own
    layout on every call) against the yardstick torch.nn.LSTM with
    cuDNN-flattened weights, forward and backward; the copy of the weights
    into a flat buffer alone, and Gluon's concatenation of the per-gate
    Parameters into the blob (rnn_layer._pack_params)."""
    from mxnet_tpu_torch.ops import rnn as trnn
    from mxnet_tpu_torch.ops.registry import get_op
    H, T, N, L = cfg["hidden"], cfg["bptt"], cfg["batch"], cfg["layers"]
    g = torch.Generator(device="cuda").manual_seed(323)
    n = trnn.rnn_param_size(L, H, H, False, "lstm")
    blob = (torch.rand(n, device="cuda", generator=g) - 0.5) * 0.05
    blob.requires_grad_()
    x = torch.randn(T, N, H, device="cuda", generator=g, requires_grad=True)
    h0 = torch.zeros(L, N, H, device="cuda")
    c0 = torch.zeros(L, N, H, device="cuda")
    dout = torch.randn(T, N, H, device="cuda", generator=g)
    op = get_op("RNN")
    attrs = op.parse_attrs(dict(state_size=H, num_layers=L, mode="lstm"))

    def ours():
        out = op.fn(attrs, None, x, blob, h0, c0)
        torch.autograd.grad(out, (x, blob), dout)

    lstm = torch.nn.LSTM(H, H, L).cuda()
    lstm.flatten_parameters()
    views = [w for per_dir in trnn._unpack(blob.detach(), L, H, H, False,
                                           "lstm")
             for ws in per_dir for w in ws]
    with torch.no_grad():
        for dst, src in zip(lstm._flat_weights, views):
            dst.copy_(src)

    def yardstick():
        out, _ = lstm(x, (h0, c0))
        torch.autograd.grad(out, [x] + list(lstm.parameters()), dout)

    def flat_copy():
        with torch.no_grad():
            for dst, src in zip(lstm._flat_weights, views):
                dst.copy_(src)

    pieces = [v.detach().clone().reshape(-1) for v in views]

    def pack():
        torch.cat(pieces)

    out = op.fn(attrs, None, x, blob, h0, c0)
    with torch.no_grad():
        want, _ = lstm(x, (h0, c0))
    err = (out - want).abs().max().item()
    timer = Timer(torch, iters=10)
    t = {}
    for tag, fn in (("ours", ours), ("yardstick", yardstick),
                    ("ours2", ours), ("yardstick2", yardstick),
                    ("flat_copy", flat_copy), ("pack", pack)):
        t[tag] = timer(fn)
    ours_ms = min(t["ours"], t["ours2"])
    yard_ms = min(t["yardstick"], t["yardstick2"])
    log("32a the LM's LSTM layers alone (2 x %d, T%d batch %d f32, forward "
        "+ backward): the RNN op on the packed blob %.3f / %.3f ms, "
        "torch.nn.LSTM with cuDNN-flattened weights %.3f / %.3f ms (in "
        "turns; difference %.3f ms per step); the weights' copy into a "
        "flat buffer alone %.4f ms (%.1f MB); Gluon's concatenation of the "
        "per-gate Parameters %.4f ms; outputs agree to %.2e [%s]"
        % (H, T, N, t["ours"], t["ours2"], t["yardstick"], t["yardstick2"],
           ours_ms - yard_ms, t["flat_copy"], n * 4 / 1e6, t["pack"], err,
           card))
    check(err <= 1e-5, "32a: the RNN op and torch.nn.LSTM disagree by %.2e"
          % err)
    del lstm, blob, x, dout, views, pieces
    torch.cuda.empty_cache()


# MXNet's example/rnn/bucketing/cudnn_lstm_bucketing.py, its defaults
BUCKET_LM = dict(vocab=10000, embed=200, hidden=200, layers=2,
                 buckets=[10, 20, 30, 40, 50, 60], batch=32, lr=0.01,
                 wd=1e-5, per_bucket=3)


def fused_lm_sym_gen(mx, stack, cfg):
    def sym_gen(seq_len):
        sym = mx.sym
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data, input_dim=cfg["vocab"],
                              output_dim=cfg["embed"], name="embed")
        stack.reset()
        out, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = sym.FullyConnected(sym.Reshape(out, shape=(-1,
                                                          cfg["hidden"])),
                                  num_hidden=cfg["vocab"], name="pred")
        pred = sym.SoftmaxOutput(pred, sym.Reshape(label, shape=(-1,)),
                                 name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def phase_fused_bucketing(torch, mx, card, cfg=BUCKET_LM):
    """32b: FusedRNNCell(200, 2 layers, lstm) unrolled per bucket in a
    BucketingModule over buckets 10-60 (cudnn_lstm_bucketing.py's
    defaults), SGD lr 0.01 wd 1e-5 through KVStore("device"), Perplexity,
    one epoch of ``per_bucket`` batches per bucket; then
    save_rnn_checkpoint, the unfused LSTMCell stack from the saved file,
    and score of both on a held-out iterator."""
    import random
    import tempfile
    from mxnet_tpu_torch.ops import rnn as trnn
    c = cfg

    def sentences(per_bucket, seed):
        rs = np.random.RandomState(seed)
        out = []
        for lo, hi in zip([1] + c["buckets"][:-1], c["buckets"]):
            for _ in range(per_bucket * c["batch"]):
                n = int(rs.randint(lo + 1, hi + 1))
                out.append(list(zipf_ids(c["vocab"] - 1, n,
                                         int(rs.randint(1 << 30))) + 1))
        return out

    random.seed(324)
    np.random.seed(324)
    it = mx.rnn.BucketSentenceIter(sentences(c["per_bucket"], 324),
                                   c["batch"], buckets=c["buckets"],
                                   invalid_label=0)
    held = mx.rnn.BucketSentenceIter(sentences(1, 325), c["batch"],
                                     buckets=c["buckets"], invalid_label=0)
    with mx.name.NameManager():
        cell = mx.rnn.FusedRNNCell(c["hidden"], num_layers=c["layers"],
                                   mode="lstm", prefix="lstm_")
    mod = mx.mod.BucketingModule(fused_lm_sym_gen(mx, cell, c),
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.gpu(0))
    mx.random.seed(0)
    init = mx.init.Mixed([".*parameters", ".*"],
                         [mx.init.Uniform(0.07),
                          mx.init.Xavier(factor_type="in", magnitude=2.34)])
    marks, keys = [], []

    def on_batch(p):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)
        keys.append(mod._curr_bucket_key)

    start = torch.cuda.Event(enable_timing=True)
    trnn.CALLS.update(cudnn=0, plain=0)
    metric = mx.metric.Perplexity(ignore_label=0)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(initializer=init)
    start.record()
    mod.fit(it, kvstore=mx.kv.create("device"), optimizer="sgd",
            optimizer_params={"learning_rate": c["lr"], "wd": c["wd"]},
            eval_metric=metric, num_epoch=1, batch_end_callback=on_batch)
    torch.cuda.synchronize()
    calls = dict(trnn.CALLS)
    ms = [start.elapsed_time(marks[0])] + [
        marks[i - 1].elapsed_time(marks[i]) for i in range(1, len(marks))]
    per_bucket = {}
    for k, m in zip(keys, ms):
        per_bucket.setdefault(k, []).append(m)
    train_ppl = metric.get()[1]
    log("32b FusedRNNCell(%d, %d layers, lstm) LM (V%d, embed %d) over "
        "buckets %s, batch %d, SGD lr %g wd %g, KVStore('device'): ms per "
        "step by bucket (the bucket's first step binds it; median of the "
        "rest): %s; training perplexity %.1f; cuDNN calls %d, plain loops "
        "%d [%s]"
        % (c["hidden"], c["layers"], c["vocab"], c["embed"], c["buckets"],
           c["batch"], c["lr"], c["wd"], "; ".join(
               "%d: first %.2f, then %s" % (k, v[0], "%.2f" % statistics.
                                            median(v[1:]) if v[1:] else "-")
               for k, v in sorted(per_bucket.items())), train_ppl,
           calls["cudnn"], calls["plain"], card))
    check(sorted(per_bucket) == c["buckets"], "32b: buckets run %s"
          % sorted(per_bucket))
    check(calls["cudnn"] >= len(keys) and calls["plain"] == 0,
          "32b: the RNN op ran cuDNN %d and the plain loop %d times over %d "
          "batches" % (calls["cudnn"], calls["plain"], len(keys)))
    arg, aux = mod.get_params()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "lstm_bucketing")
        mx.rnn.save_rnn_checkpoint(cell, prefix, 1, fused_lm_sym_gen(
            mx, cell, c)(it.default_bucket_key)[0], arg, aux)
        _, f_arg, f_aux = mx.rnn.load_rnn_checkpoint(cell, prefix, 1)
        _, u_arg, u_aux = mx.model.load_checkpoint(prefix, 1)
    check(np.array_equal(f_arg["lstm_parameters"].asnumpy(),
                         arg["lstm_parameters"].asnumpy()),
          "32b: the blob did not round-trip through the checkpoint")
    stack = cell.unfuse()
    scores = {}
    outs = {}
    held.reset()
    probe = next(iter(held))
    for tag, sym_gen, a in (("fused", fused_lm_sym_gen(mx, cell, c), f_arg),
                            ("unfused", fused_lm_sym_gen(mx, stack, c),
                             u_arg)):
        m = mx.mod.BucketingModule(sym_gen,
                                   default_bucket_key=it.default_bucket_key,
                                   context=mx.gpu(0))
        m.bind(held.provide_data, held.provide_label, for_training=False)
        m.set_params(a, f_aux if tag == "fused" else u_aux)
        held.reset()
        met = mx.metric.Perplexity(ignore_label=0)
        t0 = time.perf_counter()
        scores[tag] = dict(m.score(held, met))["perplexity"]
        score_s = time.perf_counter() - t0
        m.forward(probe, is_train=False)
        outs[tag] = (m.get_outputs()[0].asnumpy(), score_s)
    err = float(np.abs(outs["fused"][0] - outs["unfused"][0]).max())
    rel = abs(scores["fused"] - scores["unfused"]) / scores["fused"]
    log("32b save_rnn_checkpoint -> unfused LSTMCell stack: held-out "
        "perplexity fused %.3f (score %.2f s), unfused %.3f (score %.2f s), "
        "rel %.2e (tolerance 1e-4); one batch's softmax max_abs_err %.2e "
        "(tolerance 1e-5) [%s]"
        % (scores["fused"], outs["fused"][1], scores["unfused"],
           outs["unfused"][1], rel, err, card))
    check(rel <= 1e-4 and err <= 1e-5, "32b: the fused and unfused stacks "
          "disagree (perplexity rel %.2e, outputs %.2e)" % (rel, err))
    return per_bucket


def phase_recurrent(torch, mx, convert, card):
    """Phase 32: 32a (the word LM through Gluon: card vs CPU, full width,
    the LSTM layers against torch.nn.LSTM) and 32b (the symbolic bucketed
    LM over FusedRNNCell)."""
    word_lm_parity(torch, mx, convert, card)
    torch.cuda.empty_cache()
    med = word_lm_full(torch, mx, card)
    torch.cuda.empty_cache()
    word_lm_check(torch, mx, card)
    torch.cuda.empty_cache()
    word_lm_rnn_costs(torch, card)
    phase_fused_bucketing(torch, mx, card)
    torch.cuda.empty_cache()
    return med


def rnn_vs_plain(torch, mode, layers, bidir, state_outputs, dtype,
                 T=16, N=8, C=32, H=64, seed=0):
    """The RNN op on the card (cuDNN) against its plain loop on the same
    card tensors: (output errors, gradient errors, tolerance)."""
    from mxnet_tpu_torch.ops import rnn as trnn
    from mxnet_tpu_torch.ops.registry import get_op
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = 2 if bidir else 1
    n = trnn.rnn_param_size(layers, C, H, bidir, mode)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g,
                            dtype=torch.float64) * scale).to(dt)

    ins = [r(T, N, C), r(n, scale=0.2), r(layers * d, N, H)]
    if mode == "lstm":
        ins.append(r(layers * d, N, H))
    op = get_op("RNN")
    attrs = op.parse_attrs(dict(state_size=H, num_layers=layers,
                                bidirectional=bidir, mode=mode,
                                state_outputs=state_outputs))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        outs = fn(leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cots = [torch.randn(o.shape, device="cuda", dtype=torch.float64,
                            generator=torch.Generator(device="cuda")
                            .manual_seed(seed + 1 + i)).to(dt)
                for i, o in enumerate(outs)]
        grads = torch.autograd.grad(outs, leaves, cots)
        return [o.detach() for o in outs], grads

    def plain(leaves):
        w = trnn._unpack(leaves[1], layers, C, H, bidir, mode)
        out, hN, cN = trnn.rnn_plain(mode, leaves[0], w, leaves[2],
                                     leaves[3] if mode == "lstm" else None)
        if not state_outputs:
            return out
        return (out, hN, cN) if mode == "lstm" else (out, hN)

    got = run(lambda leaves: op.fn(attrs, None, *leaves))
    want = run(plain)
    tol = 1e-9 if dtype == "float64" else 1e-4
    out_err = max((a - b).abs().max().item() / max(1.0, b.abs().max()
                                                   .item())
                  for a, b in zip(got[0], want[0]))
    grad_err = max((a - b).abs().max().item() / max(1.0, b.abs().max()
                                                    .item())
                   for a, b in zip(got[1], want[1]))
    return out_err, grad_err, tol


def rnn_op_checks(torch, mx, card):
    """33a: the RNN op (cuDNN) against its plain loop on the card in every
    mode, 1-2 layers, 1-2 directions, with and without state_outputs, in
    f32 and f64, outputs and gradients; a gradient under
    ``autograd.record(train_mode=False)``; the dropout mask (keep share
    within its binomial bounds, the same after the same seed, equal to
    the plain loop's draw from the same generator); bf16 through cuDNN in
    f32."""
    from mxnet_tpu_torch.ops import rnn as trnn
    from mxnet_tpu_torch.ops.registry import get_op
    trnn.CALLS.update(cudnn=0, plain=0)
    worst = {"float32": [0.0, 0.0], "float64": [0.0, 0.0]}
    bad = []
    n = 0
    for dtype in ("float32", "float64"):
        for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
            for layers in (1, 2):
                for bidir in (False, True):
                    for so in (False, True):
                        oe, ge, tol = rnn_vs_plain(torch, mode, layers,
                                                   bidir, so, dtype,
                                                   seed=n)
                        n += 1
                        w = worst[dtype]
                        w[0], w[1] = max(w[0], oe), max(w[1], ge)
                        if oe > tol or ge > 10 * tol:
                            bad.append("%s L%d %s so=%s %s %.2e / %.2e"
                                       % (mode, layers, "bi" if bidir
                                          else "uni", so, dtype, oe, ge))
    calls = dict(trnn.CALLS)
    check(calls["cudnn"] == n and calls["plain"] == 0,
          "33a: %d cuDNN calls and %d plain loops for %d cases"
          % (calls["cudnn"], calls["plain"], n))
    log("33a RNN op on the card (cuDNN) vs its plain loop on the card, %d "
        "cases (4 modes x 1-2 layers x 1-2 directions x state_outputs x "
        "f32/f64; T16 N8 C32 H64), relative to max(1, max|ref|): f32 "
        "outputs %.2e gradients %.2e (tolerance 1e-4 / 1e-3), f64 %.2e / "
        "%.2e (1e-9 / 1e-8) [%s]"
        % (n, worst["float32"][0], worst["float32"][1],
           worst["float64"][0], worst["float64"][1], card))
    check(not bad, "33a: cuDNN vs plain outside tolerance: %s"
          % "; ".join(bad))
    # a gradient under record(train_mode=False): cuDNN's backward needs
    # its forward in training mode
    rs = np.random.RandomState(330)
    H, C, T, N = 64, 32, 16, 8
    blob = rs.randn(trnn.rnn_param_size(2, C, H, False, "lstm")) * 0.2
    x = rs.randn(T, N, C)
    grads = {}
    for tag, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        with ctx:
            a = [mx.nd.array(v, dtype="float64")
                 for v in (x, blob, np.zeros((2, N, H)),
                           np.zeros((2, N, H)))]
            for v in a[:2]:
                v.attach_grad()
            with mx.autograd.record(train_mode=False):
                out = mx.nd.RNN(*a, state_size=H, num_layers=2, mode="lstm",
                                p=0.5)
            out.backward()
            grads[tag] = [v.grad.asnumpy() for v in a[:2]]
    gerr = max(np.abs(g - w).max() for g, w in zip(grads["card"],
                                                    grads["cpu"]))
    log("33a gradient under autograd.record(train_mode=False) (p 0.5, no "
        "dropout in predict mode), f64: card (cuDNN, train=True) vs cpu "
        "%.2e (tolerance 1e-9) [%s]" % (gerr, card))
    check(gerr <= 1e-9, "33a: the train_mode=False gradient disagrees "
          "(%.2e)" % gerr)
    # dropout: an rnn_relu stack whose upper layers pass their input
    # through (Wx = I, Wh = 0, no bias) shows the masks between layers
    hid, p, layers = 256, 0.3, 3
    xs = np.abs(rs.randn(16, 32, hid)) + 0.5
    probe = np.concatenate(
        [np.concatenate([np.eye(hid).ravel(), np.zeros(hid * hid)])
         for _ in range(layers)] + [np.zeros(2 * layers * hid)])
    op = get_op("RNN")
    attrs = op.parse_attrs(dict(state_size=hid, num_layers=layers,
                                mode="rnn_relu", p=p))
    attrs["_train"] = True
    args = [torch.tensor(v, device="cuda", dtype=torch.float32)
            for v in (xs, probe, np.zeros((layers, 32, hid)))]

    def masked(seed, fn):
        mx.random.seed(seed)
        return fn(args)

    def via_op(a):
        return op.fn(attrs, None, *a)

    def via_plain(a):
        from mxnet_tpu_torch.rng import next_generator
        w = trnn._unpack(a[1], layers, hid, hid, False, "rnn_relu")
        return trnn.rnn_plain("rnn_relu", a[0], w, a[2], None, p=p,
                              train=True, gen=next_generator(a[0].device))[0]

    o1, o2 = masked(7, via_op), masked(7, via_op)
    o3, o4 = masked(8, via_op), masked(7, via_plain)
    kept = (o1 != 0).double().mean().item()
    want = (1 - p) ** (layers - 1)
    sd = (want * (1 - want) / o1.numel()) ** 0.5
    same_plain = (o1 - o4).abs().max().item()
    log("33a RNN dropout on the card (p %.1f, %d layers: two masks): keep "
        "share %.5f, binomial %.5f +- %.5f (5 sd allowed); same seed "
        "equal %s, another seed differs %s, the plain loop's draw from the "
        "same seed max_abs_err %.2e [%s]"
        % (p, layers, kept, want, sd, bool(torch.equal(o1, o2)),
           bool(not torch.equal(o1, o3)), same_plain, card))
    check(abs(kept - want) <= 5 * sd and torch.equal(o1, o2)
          and not torch.equal(o1, o3) and same_plain <= 1e-5,
          "33a: the RNN op's dropout does not follow mx.random.seed")
    # bf16: cuDNN in f32, rounded to bf16
    ins = [torch.randn(16, 8, 32, device="cuda"),
           torch.randn(trnn.rnn_param_size(2, 32, 64, True, "gru"),
                       device="cuda") * 0.2,
           torch.randn(4, 8, 64, device="cuda")]
    attrs = op.parse_attrs(dict(state_size=64, num_layers=2,
                                bidirectional=True, mode="gru"))
    got = op.fn(attrs, None, *[t.bfloat16() for t in ins])
    w = trnn._unpack(ins[1].bfloat16().float(), 2, 32, 64, True, "gru")
    ref = trnn.rnn_plain("gru", ins[0].bfloat16().float(), w,
                         ins[2].bfloat16().float(), None)[0]
    berr = (got.float() - ref).abs().max().item()
    log("33a RNN bf16 (gru, 2 layers, bidirectional): cuDNN in f32 rounded "
        "to bf16, dtype %s, vs the plain loop in f32 on the bf16 inputs "
        "%.2e (one bf16 step of |ref| <= 1: 7.8e-3) [%s]"
        % (got.dtype, berr, card))
    check(got.dtype == torch.bfloat16 and berr <= 7.9e-3,
          "33a: the bf16 RNN is off by %.2e" % berr)


def linalg_checks(torch, card, batch=64, n=256):
    """33b: the 14 linalg ops (28 names: each alias is the same op) on
    batched SPD matrices, card against CPU in f32 and f64, timed."""
    from mxnet_tpu_torch.ops.registry import get_op
    rs = np.random.RandomState(331)
    m = rs.randn(batch, n, n)
    spd = m @ m.transpose(0, 2, 1) / n + np.eye(n)
    low = np.linalg.cholesky(spd)
    b = rs.randn(batch, n, n)
    vec = rs.randn(batch, n * (n + 1) // 2)
    cases = [("_linalg_gemm", [spd, b, b], dict(alpha=0.5, beta=2.0)),
             ("_linalg_gemm2", [spd, b], dict(transpose_b=True)),
             ("_linalg_potrf", [spd], {}), ("_linalg_potri", [low], {}),
             ("_linalg_trmm", [low, b], dict(rightside=True)),
             ("_linalg_trsm", [low, b], dict(transpose=True)),
             ("_linalg_sumlogdiag", [spd], {}),
             ("_linalg_syrk", [b], dict(alpha=0.5)),
             ("_linalg_gelqf", [b[:, :n // 2]], {}),
             ("_linalg_maketrian", [vec], {}),
             ("_linalg_extracttrian", [spd], {}),
             ("_linalg_extractdiag", [spd], dict(offset=1)),
             ("_linalg_makediag", [b[:, 0]], dict(offset=-1)),
             ("_linalg_syevd", [spd], {})]
    for name, _, _ in cases:
        check(get_op(name) is get_op(name[1:]), "33b: %s and %s are not "
              "one op" % (name, name[1:]))
    rows = []
    # f32: a 256-wide decomposition's rounding (n eps ~ 1.5e-5 times the
    # matrices' condition ~5) on each side, with room
    for dtype, tol in (("float64", 1e-9), ("float32", 1e-3)):
        dt = getattr(torch, dtype)
        for name, ins, kw in cases:
            op = get_op(name)
            attrs = op.parse_attrs(kw)
            cpu = [torch.tensor(a, dtype=dt) for a in ins]
            dev = [t.cuda() for t in cpu]
            want = op.fn(attrs, *cpu)
            got = op.fn(attrs, *dev)
            torch.cuda.synchronize()
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            if name == "_linalg_syevd":
                # eigenvectors up to sign: rebuild A
                u, w = got
                got = (w, u.transpose(-1, -2) @ (w[..., None] * u))
                want = (want[1], torch.tensor(ins[0], dtype=dt))
            err = max(((g.cpu() - w).norm() / max(w.norm().item(), 1e-30))
                      .item() for g, w in zip(got, want))
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(3):
                op.fn(attrs, *dev)
            e.record()
            e.synchronize()
            rows.append("%s %s %.2e %.3f ms" % (name[8:], dtype[5:], err,
                                                s.elapsed_time(e) / 3))
            check(err <= tol, "33b: %s in %s: card vs cpu %.2e (tolerance "
                  "%.0e)" % (name, dtype, err, tol))
    log("33b linalg on %d x %d x %d SPD matrices, card vs cpu norm-wise "
        "(tolerance f64 1e-9, f32 1e-3) and card ms per call: %s [%s]"
        % (batch, n, n, "; ".join(rows), card))


def spatial_checks(torch, card, flow_batch=8):
    """33c: the 7 spatial ops (9 names) card against CPU, outputs and
    gradients at small shapes, then Correlation at FlowNetC's shape
    (256 channels at 48 x 64, max_displacement 20, stride2 2, pad 20,
    kernel 1): one pair card against CPU, and FlowNetC's batch of
    ``flow_batch`` pairs timed on the card."""
    from mxnet_tpu_torch.ops.registry import get_op
    rs = np.random.RandomState(332)

    def f(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)

    cases = [("GridGenerator", [f(4, 6)], dict(transform_type="affine",
                                              target_shape=(16, 20))),
             ("GridGenerator", [f(4, 2, 16, 20)],
              dict(transform_type="warp")),
             ("BilinearSampler", [f(4, 8, 16, 20),
                                  rs.uniform(-1.1, 1.1, (4, 2, 12, 14))
                                  .astype(np.float32)], {}),
             ("SpatialTransformer", [f(4, 8, 16, 20),
                                     (np.array([[0.9, 0.1, 0, -0.1, 1.1, 0]]
                                               * 4) + f(4, 6, scale=0.05))
                                     .astype(np.float32)],
              dict(target_shape=(12, 14))),
             ("Correlation", [f(2, 16, 24, 32), f(2, 16, 24, 32)],
              dict(kernel_size=3, max_displacement=4, stride1=1, stride2=2,
                   pad_size=4)),
             ("Crop", [f(2, 3, 16, 20), f(2, 3, 10, 12)],
              dict(num_args=2, center_crop=True)),
             ("_image_to_tensor", [rs.randint(0, 256, (2, 16, 20, 3))
                                   .astype(np.uint8)], {}),
             ("_image_normalize", [f(2, 3, 16, 20)],
              dict(mean=(0.1, 0.2, 0.3), std=(0.5, 0.6, 0.7)))]
    for name in ("_image_to_tensor", "_image_normalize"):
        check(get_op(name) is get_op(name[1:]), "33c: %s and %s are not "
              "one op" % (name, name[1:]))
    worst = 0.0
    for name, ins, kw in cases:
        op = get_op(name)
        attrs = op.parse_attrs(kw)
        res = {}
        for dev in ("cuda", "cpu"):
            leaves = [torch.tensor(a, device=dev) for a in ins]
            diff = [t for t in leaves if t.is_floating_point()][:1 if name
                                                                == "Crop"
                                                                else None]
            for t in diff:
                t.requires_grad_()
            out = op.fn(attrs, *leaves)
            grads = torch.autograd.grad(out, diff, torch.ones_like(out)) \
                if diff else ()
            res[dev] = [out.detach().cpu()] + [g_.cpu() for g_ in grads]
        err = max(((a.float() - b.float()).abs().max()
                   / max(1.0, b.float().abs().max().item())).item()
                  for a, b in zip(res["cuda"], res["cpu"]))
        worst = max(worst, err)
        check(err <= 1e-4, "33c: %s card vs cpu %.2e" % (name, err))
    d1, d2 = f(flow_batch, 256, 48, 64), f(flow_batch, 256, 48, 64)
    op = get_op("Correlation")
    attrs = op.parse_attrs(dict(kernel_size=1, max_displacement=20,
                                stride1=1, stride2=2, pad_size=20))
    t0 = time.perf_counter()
    want = op.fn(attrs, torch.tensor(d1[:1]), torch.tensor(d2[:1]))
    cpu_s = time.perf_counter() - t0
    a, b = torch.tensor(d1, device="cuda"), torch.tensor(d2, device="cuda")
    got = op.fn(attrs, a, b)
    torch.cuda.synchronize()
    err = ((got[:1].cpu() - want).abs().max() / want.abs().max()).item()
    corr_ms = Timer(torch, iters=5)(lambda: op.fn(attrs, a, b))
    log("33c spatial ops card vs cpu (outputs and gradients, relative to "
        "max(1, max|ref|)): worst %.2e (tolerance 1e-4); Correlation at "
        "FlowNetC's shape (%d, 256, 48, 64), max_displacement 20, stride2 "
        "2, pad 20, kernel 1 -> %s: the first pair card vs cpu %.2e "
        "(tolerance 1e-5), card %.3f ms for the batch, cpu %.2f s for one "
        "pair [%s]" % (worst, flow_batch, tuple(got.shape), err, corr_ms,
                       cpu_s, card))
    check(tuple(got.shape) == (flow_batch, 441, 48, 64) and err <= 1e-5,
          "33c: Correlation at FlowNetC's shape: %s, %.2e"
          % (tuple(got.shape), err))


def phase_recurrent_ops(torch, mx, card):
    """Phase 33: 33a-33c."""
    rnn_op_checks(torch, mx, card)
    linalg_checks(torch, card)
    spatial_checks(torch, card)
    torch.cuda.empty_cache()


# -- phase 34: SSD at full width through Module.fit ---------------------------

# models/ssd.py's training symbol at the reference's data shape (MXNet's
# example/ssd: 300x300, the 20 PASCAL VOC classes) with example/ssd/
# train.py's SGD defaults, on seeded synthetic scenes in the manner of
# example/detection/train_ssd_toy.py (VOC is not in the repository): 4
# batches of 32 per epoch, labels padded with -1 rows to 50
SSD = dict(num_classes=20, nms_thresh=0.45, nms_topk=400)
SSD_DATA = dict(batch=32, hw=300, rows=50, batches=4, epochs=4, max_obj=5)
SSD_SGD = dict(learning_rate=0.002, momentum=0.9, wd=5e-4)
# the training check: a fresh Module on one repeated batch for its steps;
# the cross-entropy of the forward before the last update must lie its
# margin below the first's.  Over all 30,120 anchors of 32 images it falls
# slowly and smoothly at lr 0.002: 3.3190 -> 3.2831 in 10 steps, each
# step's fall growing with the momentum (NVIDIA H100 80GB HBM3, 700 W)
SSD_CHECK = dict(steps=12, margin=0.03)
F64_FLOPS_S = 34e12           # H100 SXM f64 outside the tensor cores
# the operations an NMS pair needs: every pair the greedy rule decides,
# four comparisons (do the boxes overlap); a pair with an IoU > 0 besides
# its IoU against t: min, max and sub for each side, inter, the later
# box's area (2 sub, mul), the union (add, sub, the 1e-12 clamp), t x den
# and one comparison
NMS_TEST_OPS, NMS_IOU_OPS = 4, 15
NMS_CLUSTERS = (1, 2, 4, 8, 16)


def ssd_module(mx, net, ctx, X, Y, args=None, auxs=None):
    """A Module of ``net`` bound for (X, Y) on ``ctx`` with SSD_SGD, from
    ``args``/``auxs`` (host arrays) or Xavier after mx.random.seed(0)."""
    mod = mx.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=ctx)
    mod.bind(data_shapes=[("data", X.shape)],
             label_shapes=[("label", Y.shape)])
    if args is None:
        mx.random.seed(0)
        mod.init_params(initializer=mx.init.Xavier())
    else:
        from mxnet_tpu_torch import convert
        a, x = convert.module_params_from_numpy(args, auxs)
        mod.init_params(arg_params=a, aux_params=x)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SSD_SGD))
    return mod


def ssd_batch(mx, ctx, X, Y):
    return mx.io.DataBatch(data=[mx.nd.array(X, ctx=ctx)],
                           label=[mx.nd.array(Y, ctx=ctx)])


def ssd_ce(mod):
    """Mean -log p[target] over every anchor of the last forward
    (cls_prob against cls_label, both outputs of the training symbol)."""
    prob, _, label = mod.get_outputs()[:3]
    p, t = prob._handle, label._handle.long()
    return float(-p.gather(1, t[:, None]).clamp(min=1e-30).log().mean())


def ssd_f64_update(torch, net, args, auxs, X, Y, rescale):
    """The first SGD step's update (SSD_SGD, momentum state 0) from the
    graph's float64 gradient on the CPU: -lr (rescale g + wd w)."""
    from mxnet_tpu_torch.executor import GraphProgram
    prog = GraphProgram(net)
    leaves = {n: torch.from_numpy(args[n]).double().requires_grad_()
              for n in args}
    feed = dict(leaves, data=torch.from_numpy(X).double(),
                label=torch.from_numpy(Y).double())
    outs, _ = prog.evaluate([feed[n] for n in prog.arg_names],
                            [torch.from_numpy(auxs[n]).double()
                             for n in prog.aux_names], train=True)
    live = [o for o in outs if o.requires_grad]
    grads = torch.autograd.grad(live, list(leaves.values()),
                                [torch.ones_like(o) for o in live],
                                allow_unused=True)
    lr, wd = SSD_SGD["learning_rate"], SSD_SGD["wd"]
    return {n: -lr * ((0.0 if g is None else rescale * g.numpy())
                      + wd * args[n].astype(np.float64))
            for n, g in zip(leaves, grads)}


def ssd_parity(torch, mx, kernels, card):
    """One Module step at 64x64, batch 4, on the card and on the CPU from
    the same parameters: the losses within 1e-4; every update within 1e-3
    of its tensor's largest change, or no further than the CPU's own,
    from the same step in float64, plus one float32 ulp of the weight
    (the CPU's float32 weight gradients of the first convolutions stand
    ~2e-2 from float64 at this input: the log prints both); a bias that
    BatchNorm subtracts again has a gradient of 0 up to rounding, and its
    update stays under 1e-3 of the model's largest.  Then
    MultiBoxDetection on the card fed the CPU forward's class
    probabilities and location predictions equals the CPU's detections."""
    import torch_cases as tc
    from mxnet_tpu_torch.executor import GraphProgram
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.ops.registry import get_op
    X, Y = tc.ssd_scenes(4, 64, SSD_DATA["rows"], SSD["num_classes"], 1)
    net = ssd.get_symbol_train(**SSD)
    start = ssd_module(mx, net, mx.cpu(), X, Y)
    args, auxs = ({k: v.asnumpy() for k, v in part.items()}
                  for part in start.get_params())
    got = {}
    for key, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        mod = ssd_module(mx, net, ctx, X, Y, args, auxs)
        mod.forward_backward(ssd_batch(mx, ctx, X, Y))
        ce = ssd_ce(mod)
        loc = float(mod.get_outputs()[1].asnumpy().sum())
        mod.update()
        got[key] = (ce, loc, {k: v.asnumpy() for k, v in
                              mod.get_params()[0].items()})
        rescale = mod._optimizer.rescale_grad
    (ce_c, loc_c, p_c), (ce_h, loc_h, p_h) = got["card"], got["cpu"]
    want = ssd_f64_update(torch, net, args, auxs, X, Y, rescale)
    largest = max(float(np.abs(u).max()) for u in want.values())
    gaps = []
    for n, u in want.items():
        c, h = p_c[n] - args[n], p_h[n] - args[n]
        if n.endswith("_bias") and n[:-5] + "_bn_gamma" in args:
            moved = max(np.abs(c).max(), np.abs(h).max())
            check(moved <= 1e-3 * largest, "SSD %s: a bias before "
                  "BatchNorm moved by %.3g" % (n, moved))
            continue
        change = float(np.abs(u).max())
        # w + update rounds to the weight's float32 ulp in either package
        ulp = float(np.spacing(np.abs(args[n]).max().astype(np.float32)))
        err_c, err_h = (float(np.abs(x - u).max()) for x in (c, h))
        gaps.append((err_c / change, err_h / change, n,
                     err_c <= max(1e-3 * change, err_h) + ulp))
    gaps.sort(reverse=True)
    log("SSD 64x64 batch 4, one Module step from one state: updates "
        "against the float64 step, worst card %s; the CPU's f32 step, "
        "worst %s (each of its tensor's largest change); cross-entropy "
        "%.7f vs %.7f, loc loss %.6f vs %.6f card vs cpu [%s]"
        % (", ".join("%s %.3g" % (n, c) for c, _, n, _ in gaps[:3]),
           ", ".join("%s %.3g" % (n, h) for _, h, n, _ in
                     sorted(gaps, key=lambda g: -g[1])[:3]),
           ce_c, ce_h, loc_c, loc_h, card))
    for c, h, n, ok in gaps:
        check(ok, "SSD step %s on the card stands %.3g of its largest "
              "change from the float64 step, the CPU %.3g (tolerance 1e-3, "
              "or the CPU's own, + one ulp of the weight)" % (n, c, h))
    check(abs(ce_c - ce_h) <= 1e-4 * abs(ce_h)
          and abs(loc_c - loc_h) <= 1e-4 * abs(loc_h),
          "SSD losses differ: cross-entropy %.7f vs %.7f, loc %.6f vs %.6f"
          % (ce_c, ce_h, loc_c, loc_h))
    # MultiBoxDetection of the CPU forward's outputs, on both devices
    inner = net.get_internals()
    heads = mx.sym.Group([inner["cls_prob_output"],
                          inner["loc_preds_output"],
                          inner["anchors_output"]])
    prog = GraphProgram(heads)
    feed = dict(args, data=X, label=Y)
    ins = [torch.from_numpy(np.asarray(feed[n])) for n in prog.arg_names]
    with torch.no_grad():
        heads_cpu, _ = prog.evaluate(ins, [torch.from_numpy(auxs[n]) for n
                                           in prog.aux_names], train=True)
    op = get_op("_contrib_MultiBoxDetection")
    attrs = op.parse_attrs(dict(nms_threshold=SSD["nms_thresh"],
                                nms_topk=SSD["nms_topk"]))
    det_h = op.fn(attrs, *heads_cpu)
    before = kernels.LAUNCHES["greedy_nms_f64"]
    det_c = op.fn(attrs, *[t.cuda() for t in heads_cpu]).cpu()
    check(kernels.LAUNCHES["greedy_nms_f64"] == before + 1,
          "MultiBoxDetection on the card did not launch the NMS kernel")
    same = torch.equal(det_c[..., :2], det_h[..., :2])
    box_err = float((det_c[..., 2:] - det_h[..., 2:]).abs().max())
    check(same and box_err <= 1e-6, "MultiBoxDetection card vs cpu: class "
          "and score columns equal %s, boxes within %.3g" % (same, box_err))
    log("MultiBoxDetection on the card from the CPU forward's cls_prob / "
        "loc_preds (%s): ids and scores equal, boxes within %.3g "
        "(tolerance 1e-6: float64 exp on two libraries), %d detections "
        "kept [%s]" % (tuple(det_h.shape), box_err,
                       int((det_h[..., 0] >= 0).sum()), card))


# device kernel name fragments -> group of the SSD step's time
SSD_GROUPS = (("NMS", ("greedy_nms",)),
              ("convolutions", ("conv", "wgrad", "dgrad", "fprop",
                                "implicit_gemm", "xmma", "winograd",
                                "cudnn")),
              ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw",
                              "welford")))


def captured_nms(torch, kernels, fn):
    """Run ``fn()`` with ``kernels.greedy_nms`` watched; returns the last
    call's boxes, thresh, ids, valid and keep mask."""
    seen = {}
    orig = kernels.greedy_nms

    def capture(boxes, thresh, ids=None, valid=None):
        keep = orig(boxes, thresh, ids=ids, valid=valid)
        seen.update(boxes=boxes, thresh=thresh, ids=ids, valid=valid,
                    keep=keep)
        return keep

    kernels.greedy_nms = capture
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        kernels.greedy_nms = orig
    return seen


def nms_plan(B, n, elem_bytes, cluster=0, lib=None):
    """``csrc/nms.cu``'s launch layout for (B, n) boxes: cluster size,
    flags a thread, of them in shared memory, shared memory bytes a CTA,
    clusters the card holds at once, waves, candidates a step settles;
    ``lib`` as in :func:`nms_exchange_us`."""
    import ctypes
    out = (ctypes.c_int * 7)()
    rc = nms_lib(lib).mxt_greedy_nms_plan(B, n, elem_bytes, cluster, out)
    check(rc == 0, "mxt_greedy_nms_plan(%d, %d) failed: %d" % (B, n, rc))
    return dict(zip(("cluster", "flags", "on_chip", "smem", "resident",
                     "waves", "candidates"), out))


def nms_ops(pairs, overlaps):
    """Operations the greedy rule needs on this data: NMS_TEST_OPS for each
    pair it decides, NMS_IOU_OPS more for each one with an IoU > 0."""
    return NMS_TEST_OPS * int(pairs) + NMS_IOU_OPS * int(overlaps)


def nms_lib(lib):
    from mxnet_tpu_torch.ops import build
    return build.library("nms") if lib is None else lib


def nms_exchange_us(torch, cluster, bare=0, rounds=20000, lib=None):
    """us per round of the NMS kernel's per-step exchange between the
    CTAs of one cluster (bare: its barrier alone, barrier.cluster, or
    __syncthreads for cluster 1), from CUDA events around ``rounds`` of
    them; ``lib``: a build of csrc/nms.cu (default the port's)."""
    probe = nms_lib(lib).mxt_nms_barrier_probe
    stream = torch.cuda.current_stream().cuda_stream
    check(probe(cluster, 100, bare, stream) == 0, "the NMS probe failed")
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    rc = probe(cluster, rounds, bare, stream)
    e.record()
    e.synchronize()
    check(rc == 0, "the NMS probe failed: %d" % rc)
    return a.elapsed_time(e) * 1e3 / rounds


def nms_by_cluster(torch, kernels, timer, boxes, thresh, ids, valid, want,
                   lib=None):
    """The kernel's ms at each cluster size it may pick (cold L2), each
    keep mask held to ``want``; ``lib`` as in :func:`nms_exchange_us`."""
    B, n = boxes.shape[:2]
    f64 = boxes.dtype == torch.float64
    fn = getattr(nms_lib(lib), "mxt_greedy_nms_cluster"
                 + ("_f64" if f64 else "_f32"))
    ok = None if valid is None else valid.to(torch.uint8)
    ids = None if ids is None else ids.to(boxes.dtype)
    keep = torch.empty(B, n, dtype=torch.uint8, device=boxes.device)
    t = kernels._nms_threshold(boxes.dtype, thresh)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for C in NMS_CLUSTERS:
        if C * 1024 * 64 < n:
            continue

        def call():
            return fn(boxes.data_ptr(),
                      None if ids is None else ids.data_ptr(),
                      None if ok is None else ok.data_ptr(), keep.data_ptr(),
                      B, n, C, t, stream)

        check(call() == 0, "the NMS kernel at cluster %d failed" % C)
        torch.cuda.synchronize()
        check(torch.equal(keep.bool(), want),
              "the NMS kernel at cluster %d differs from its plain version"
              % C)
        out[C] = timer(call)
    return out


def nms_chain(torch, keep, valid, elem_bytes):
    """The launch's layout and two floors of its chain, from the most
    kept, valid boxes of an image: the chain floor, those boxes x one
    barrier round trip at the picked cluster size (barrier.cluster;
    __syncthreads for one CTA) x waves, a barrier for each kept box; and
    the exchange floor, the steps the kernel needs at least (each
    settles up to ``candidates`` boxes) x one measured round of its
    exchange x waves: what no work at all would take."""
    B, n = keep.shape
    plan = nms_plan(B, n, elem_bytes)
    kept = keep if valid is None else keep & valid
    boxes = int(kept.sum(1).max())
    steps = -(-boxes // plan["candidates"])
    us = nms_exchange_us(torch, plan["cluster"])
    bare = nms_exchange_us(torch, plan["cluster"], bare=1)
    return dict(plan=plan, kept_boxes=boxes, steps=steps, exchange_us=us,
                barrier_us=bare,
                chain_floor_ms=boxes * bare * plan["waves"] / 1e3,
                exchange_floor_ms=steps * us * plan["waves"] / 1e3)


def nms_floors_text(chain):
    """nms_chain's two floors in words."""
    return ("chain floor %.4f ms: %d kept, valid boxes in the longest image "
            "x %.3f us (the barrier alone at cluster %d) x %d wave(s); "
            "exchange floor %.4f ms: %d steps x %.3f us (a step's exchange "
            "of %d candidates alone) x %d wave(s)"
            % (chain["chain_floor_ms"], chain["kept_boxes"],
               chain["barrier_us"], chain["plan"]["cluster"],
               chain["plan"]["waves"], chain["exchange_floor_ms"],
               chain["steps"], chain["exchange_us"],
               chain["plan"]["candidates"], chain["plan"]["waves"]))


def ssd_nms_row(torch, kernels, timer, boxes, valid, keep, card):
    """The NMS kernel on the step's own sorted boxes: equal to its plain
    version on the card, timed with a cold L2, with the bound of the
    pairs this data needs (counted by the plain version, :func:`nms_ops`),
    the chain floor, and its time at each cluster size."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    pairs = torch.zeros(1, dtype=torch.int64, device="cuda")
    overlaps = torch.zeros(1, dtype=torch.int64, device="cuda")
    t0.record()
    plain = kernels.greedy_nms_plain(boxes, SSD["nms_thresh"], valid=valid,
                                     pairs=pairs, overlaps=overlaps)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    mism = int((plain != keep).sum())
    check(mism == 0, "the NMS kernel differs from its plain version on %d "
          "of the step's %d boxes" % (mism, keep.numel()))
    again = kernels.greedy_nms(boxes, SSD["nms_thresh"], valid=valid)
    check(torch.equal(again, keep), "the NMS kernel's rerun differs")
    ms = timer(lambda: kernels.greedy_nms(boxes, SSD["nms_thresh"],
                                          valid=valid))
    B, n = keep.shape
    nbytes = B * n * (4 * 8 + 1 + 1)
    ops = nms_ops(pairs, overlaps)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F64_FLOPS_S
    row = {"name": "greedy_nms_f64", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/nms.cu",
           "replaces": "mxnet_tpu/ops/contrib.py:154",
           "note": "no Pallas kernel: _greedy_nms is a lax.fori_loop; the "
                   "port's kernel replaces that loop",
           "shape": "MultiBoxDetection of the SSD step: (%d, %d, 4) f64 "
                    "sorted boxes, %d valid, threshold %g" % (
                        B, n, int(valid.sum()), SSD["nms_thresh"]),
           "launches_per_step": 1, "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None,
           "library_call": "none: no PyTorch call computes a greedy NMS",
           "pairs": int(pairs), "overlapping_pairs": int(overlaps),
           "kept": int(keep.sum())}
    chain = nms_chain(torch, keep, valid, 8)
    row.update({k: chain[k] for k in ("chain_floor_ms", "exchange_floor_ms",
                                      "barrier_us", "exchange_us",
                                      "kept_boxes", "steps")},
               layout=chain["plan"])
    by_c = nms_by_cluster(torch, kernels, timer, boxes, SSD["nms_thresh"],
                          None, valid, keep)
    row["ms_by_cluster"] = by_c
    log("  NMS kernel on the step's sorted boxes (%d x %d f64, %d valid): "
        "equal to its plain version (0 of %d flags differ), %d kept; %.4f "
        "ms with a cold L2, plain version %.1f ms (with its count of the "
        "pairs); %d pairs x %d operations + %d with an IoU > 0 x %d at 34 "
        "TFLOP/s f64 = %.4f ms, %.1f MB at 3.35 TB/s = %.4f ms: bound %.4f "
        "ms (%s) [%s]"
        % (B, n, int(valid.sum()), keep.numel(), row["kept"], ms, plain_ms,
           row["pairs"], NMS_TEST_OPS, row["overlapping_pairs"], NMS_IOU_OPS,
           t_ops * 1e3, nbytes / 1e6, t_bytes * 1e3, row["bound_ms"],
           row["bound_by"], card))
    log("  its layout %s; %s; ms by cluster size %s [%s]"
        % (chain["plan"], nms_floors_text(chain),
           ", ".join("%d: %.4f" % kv for kv in by_c.items()), card))
    return row


def phase_ssd(torch, mx, kernels, card):
    """SSD trained at full width through Module.fit (32 x 3 x 300 x 300,
    f32, TF32 off): images/s from CUDA events at each batch end, spread,
    the NMS kernel's ms and launches, idle share and time by group of one
    profiled step, peak memory; the kernel against its plain version on
    the step's own sorted boxes; the card-vs-CPU step at 64x64; the
    cross-entropy falling on a repeated batch; the deploy symbol's
    forward at batch 32.  Returns (the fit's launches, the NMS row)."""
    import torch_cases as tc
    from mxnet_tpu_torch.models import ssd
    from torch.profiler import ProfilerActivity, profile
    ssd_parity(torch, mx, kernels, card)
    d = SSD_DATA
    n_img = d["batch"] * d["batches"]
    X, Y = tc.ssd_scenes(n_img, d["hw"], d["rows"], SSD["num_classes"], 0,
                         max_obj=d["max_obj"])
    net = ssd.get_symbol_train(**SSD)
    it = mx.io.NDArrayIter(X, {"label": Y}, batch_size=d["batch"],
                           label_name="label")
    mod = mx.mod.Module(net, data_names=("data",), label_names=("label",))
    steps = d["batches"] * d["epochs"]
    ev, prof, launches = [], {}, []

    def on_batch(p):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)
        launches.append(kernels.LAUNCHES["greedy_nms_f64"])
        if len(ev) == steps - 1:
            torch.cuda.synchronize()
            prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif len(ev) == steps:
            torch.cuda.synchronize()
            prof["wall"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].__exit__(None, None, None)

    torch.backends.cudnn.benchmark = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(0)
    kernels.reset_launches()
    t_fit = time.perf_counter()
    mod.fit(it, optimizer="sgd", optimizer_params=dict(SSD_SGD),
            initializer=mx.init.Xavier(),
            eval_metric=mx.metric.Loss(output_names=["loc_loss_output"],
                                       label_names=[]),
            batch_end_callback=on_batch, num_epoch=d["epochs"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    got = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(len(ev) == steps, "fit ran %d steps, want %d" % (len(ev), steps))
    check(got["greedy_nms_f64"] == steps and
          all(b - a == 1 for a, b in zip([0] + launches, launches)),
          "the NMS kernel launched %s times per step, want once"
          % [b - a for a, b in zip([0] + launches, launches)])
    # step i (1-based) ends at ev[i-1]; steps that start an epoch carry
    # the epoch end; the first two warm cuDNN's choice; the last profiled
    inner = [ev[i - 2].elapsed_time(ev[i - 1]) for i in range(3, steps)
             if (i - 1) % d["batches"]]
    med = statistics.median(inner)
    n_params = sum(int(np.prod(a.shape)) for a in
                   mod.get_params()[0].values())
    det_shape = tuple(mod.get_outputs()[3].shape)   # (batch, anchors, 6)
    log("SSD (models/ssd.py get_symbol_train(num_classes=20, nms_thresh="
        "0.45, nms_topk=400)) %d x 3 x %d x %d f32, %d anchors, %.2f M "
        "parameters, Module.fit SGD lr %g momentum %g wd %g: %d steps in "
        "%.1f s" % (d["batch"], d["hw"], d["hw"], det_shape[1],
                    n_params / 1e6,
                    SSD_SGD["learning_rate"], SSD_SGD["momentum"],
                    SSD_SGD["wd"], steps, fit_s))
    check(len(inner) >= 10, "only %d timed steps" % len(inner))
    log("  step ms (CUDA events at batch end, steps inside an epoch after "
        "2 warm-up): %s; median %.2f (spread %.2f-%.2f) = %.1f images/s; "
        "NMS launches per step %s [%s]"
        % (", ".join("%.2f" % x for x in inner), med, min(inner),
           max(inner), d["batch"] / med * 1e3,
           [b - a for a, b in zip([0] + launches, launches)], card))
    by_kernel = {k: (us / 1e3, cnt)
                 for k, (us, cnt) in device_by_kernel(prof["p"]).items()}
    busy = sum(ms for ms, _ in by_kernel.values())
    if busy:
        groups = {g: 0.0 for g, _ in SSD_GROUPS}
        groups["the rest"] = 0.0
        for key, (ms, _cnt) in by_kernel.items():
            low = key.lower()
            groups[next((g for g, frags in SSD_GROUPS
                         if any(f in low for f in frags)),
                        "the rest")] += ms
        log("  profiled step: device busy %.2f ms of %.2f ms, idle share "
            "%.3f; by group: %s [%s]"
            % (busy, prof["wall"], 1 - busy / prof["wall"],
               ", ".join("%s %.2f ms" % kv for kv in groups.items()), card))
        for key, (ms, cnt) in sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1][0])[:10]:
            log("    %9.3f ms  x%-5d %s" % (ms, cnt, key[:90]))
        check(groups["NMS"] > 0, "the profiled step ran no NMS kernel")
    else:
        log("  device busy: not measured (the profiler saw no device time)")
    log("  peak memory allocated %.2f GB [%s]" % (peak / 1e9, card))
    # the step's own sorted boxes: one more forward, its NMS call captured
    it.reset()
    seen = captured_nms(torch, kernels, lambda: mod.forward(
        next(iter(it)), is_train=True))
    row = ssd_nms_row(torch, kernels, Timer(torch), seen["boxes"],
                      seen["valid"], seen["keep"], card)
    det = mod.get_outputs()[3].asnumpy()
    check(np.isfinite(det).all() and det.shape == det_shape
          and ((det[..., 0] >= 0) == (det[..., 1] > 0)).all(),
          "det_out: shape %s, finite %s" % (det.shape,
                                            np.isfinite(det).all()))
    del mod, seen
    torch.cuda.empty_cache()
    # training check: a fresh Module on one repeated batch
    Xb, Yb = X[:d["batch"]], Y[:d["batch"]]
    mod = ssd_module(mx, net, mx.gpu(0), Xb, Yb)
    batch = ssd_batch(mx, mx.gpu(0), Xb, Yb)
    ces = []
    for _ in range(SSD_CHECK["steps"]):
        mod.forward_backward(batch)
        ces.append(ssd_ce(mod))
        mod.update()
    ok = bool(np.all(np.isfinite(ces))
              and ces[-1] <= ces[0] - SSD_CHECK["margin"])
    log("  training check: a fresh Module on one repeated batch, %d steps: "
        "cross-entropy %s; must fall by %g: %s [%s]"
        % (SSD_CHECK["steps"], ", ".join("%.4f" % c for c in ces),
           SSD_CHECK["margin"], "passed" if ok else "FAILED", card))
    check(ok, "SSD: the cross-entropy did not fall by %g (%.4f -> %.4f)"
          % (SSD_CHECK["margin"], ces[0], ces[-1]))
    del mod, batch
    torch.cuda.empty_cache()
    # the deploy symbol's forward
    dep = mx.mod.Module(ssd.get_symbol(**SSD), data_names=("data",),
                        label_names=None)
    dep.bind(data_shapes=[("data", Xb.shape)], for_training=False)
    mx.random.seed(0)
    dep.init_params(initializer=mx.init.Xavier())
    db = mx.io.DataBatch(data=[mx.nd.array(Xb, ctx=mx.gpu(0))])
    ts = []
    for _ in range(2 + 10):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        dep.forward(db, is_train=False)
        e.record()
        out = dep.get_outputs()[0]
        e.synchronize()
        ts.append(s.elapsed_time(e))
    dmed = statistics.median(ts[2:])
    log("  deploy symbol (get_symbol) forward at batch %d: median %.2f ms "
        "(spread %.2f-%.2f) = %.1f images/s, detections %s, %d kept in "
        "the first image [%s]"
        % (d["batch"], dmed, min(ts[2:]), max(ts[2:]),
           d["batch"] / dmed * 1e3, tuple(out.shape),
           int((out.asnumpy()[0, :, 0] >= 0).sum()), card))
    torch.backends.cudnn.benchmark = False
    del dep
    torch.cuda.empty_cache()
    return got, row


# -- phase 35: the detection ops at realistic sizes, and the five conv nets --

# Faster R-CNN's RPN on a 600 x 1000 image (feature stride 16: a 38 x 63
# map, 9 anchors as the reference's rcnn example sets them, the JAX
# defaults 6000 -> 300), its 300 ROIs pooled to 7 x 7 from a 512-channel
# map, R-FCN's position-sensitive pooling over 21 classes at 7 x 7, and
# a 3 x 3 deformable convolution on a 256-channel map
RCNN = dict(batch=2, h=38, w=63, stride=16, scales=(8, 16, 32),
            ratios=(0.5, 1, 2), rois=300, channels=512, classes=21, k=7,
            deform_channels=256)


def rcnn_rois(rs, R, H, W, stride, batch=1):
    """R proposals in image coordinates (at least 16 pixels a side)."""
    ih, iw = H * stride, W * stride
    x0 = rs.uniform(0, iw - 16, R)
    y0 = rs.uniform(0, ih - 16, R)
    x1 = x0 + rs.uniform(16, iw, R) * rs.uniform(0.05, 1, R)
    y1 = y0 + rs.uniform(16, ih, R) * rs.uniform(0.05, 1, R)
    return np.stack([rs.randint(0, batch, R), x0, y0, np.minimum(x1, iw - 1),
                     np.minimum(y1, ih - 1)], 1).astype(np.float32)


def proposal_case(rs):
    """MultiProposal's inputs at RCNN's size (scores, box deltas, image
    info as numpy float32) and its attributes."""
    c = RCNN
    A = len(c["scales"]) * len(c["ratios"])
    fg = rs.rand(c["batch"], A, c["h"], c["w"]).astype(np.float32)
    inputs = [np.concatenate([1 - fg, fg], 1),
              (rs.randn(c["batch"], 4 * A, c["h"], c["w"]) * 0.2)
              .astype(np.float32),
              np.array([[c["h"] * c["stride"], c["w"] * c["stride"], 1]]
                       * c["batch"], np.float32)]
    return inputs, dict(scales=c["scales"], ratios=c["ratios"],
                        feature_stride=c["stride"], output_score=True)


def det_op_case(torch, name, attrs, inputs, timer):
    """The op on the card and on the CPU from the same numpy inputs:
    (card outputs, cpu outputs as tensors on the CPU, card ms with a cold
    L2, cpu ms)."""
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op(name)
    a = op.parse_attrs(dict(attrs))
    cpu = [torch.from_numpy(x) for x in inputs]
    card = [t.cuda() for t in cpu]

    def run(ts):
        out = op.fn(a, *ts)
        return list(out) if isinstance(out, tuple) else [out]

    with torch.no_grad():
        t0 = time.perf_counter()
        want = run(cpu)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        got = [o.cpu() for o in run(card)]
        ms = timer(lambda: run(card))
    return got, want, ms, cpu_ms


def proposal_nms(torch, kernels, inputs, attrs, card):
    """MultiProposal's own NMS call on the card, alone: equal to the plain
    version, rerun equal, its ms with a cold L2 beside the plain version's,
    the bound, the chain floor and the ms at each cluster size."""
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op("_contrib_MultiProposal")
    a = op.parse_attrs(dict(attrs))
    card_in = [torch.from_numpy(x).cuda() for x in inputs]
    seen = captured_nms(torch, kernels, lambda: op.fn(a, *card_in))
    boxes, thresh = seen["boxes"], seen["thresh"]
    ids, valid, keep = seen["ids"], seen["valid"], seen["keep"]
    pairs = torch.zeros(1, dtype=torch.int64, device="cuda")
    overlaps = torch.zeros(1, dtype=torch.int64, device="cuda")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = kernels.greedy_nms_plain(boxes, thresh, ids=ids, valid=valid,
                                    pairs=pairs, overlaps=overlaps)
    t1.record()
    torch.cuda.synchronize()
    check(torch.equal(keep, want), "MultiProposal's NMS differs from its "
          "plain version on %d flags" % int((keep != want).sum()))
    check(torch.equal(kernels.greedy_nms(boxes, thresh, ids=ids,
                                         valid=valid), keep),
          "MultiProposal's NMS rerun differs")
    timer = Timer(torch)
    ms = timer(lambda: kernels.greedy_nms(boxes, thresh, ids=ids,
                                          valid=valid))
    B, n = keep.shape
    t_ops = nms_ops(pairs, overlaps) / F64_FLOPS_S
    t_bytes = B * n * (4 * boxes.element_size() + 2) / HBM_BYTES_S
    chain = nms_chain(torch, keep, valid, boxes.element_size())
    by_c = nms_by_cluster(torch, kernels, timer, boxes, thresh, ids, valid,
                          keep)
    out = dict(shape="MultiProposal's NMS: (%d, %d, 4) %s, threshold %g"
               % (B, n, str(boxes.dtype)[6:], thresh), ms=ms,
               plain_ms=t0.elapsed_time(t1), pairs=int(pairs),
               overlapping_pairs=int(overlaps), kept=int(keep.sum()),
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               layout=chain["plan"], ms_by_cluster=by_c)
    out.update({k: chain[k] for k in ("chain_floor_ms", "exchange_floor_ms",
                                      "barrier_us", "exchange_us",
                                      "kept_boxes", "steps")})
    log("  its NMS alone (%d x %d %s, threshold %g): equal to its plain "
        "version, %d kept, %d pairs (%d with an IoU > 0); %.4f ms with a "
        "cold L2, plain version %.1f ms; bound %.4f ms (%s); layout %s; %s; "
        "ms by cluster size %s [%s]"
        % (B, n, str(boxes.dtype)[6:], thresh, out["kept"], out["pairs"],
           out["overlapping_pairs"], ms, out["plain_ms"], out["bound_ms"],
           out["bound_by"], chain["plan"], nms_floors_text(chain),
           ", ".join("%d: %.4f" % kv for kv in by_c.items()), card))
    return out


def phase_detection_ops(torch, kernels, card):
    """The detection ops at Faster R-CNN's and R-FCN's sizes, card vs CPU
    within stated tolerances, timed; returns MultiProposal's NMS alone
    (:func:`proposal_nms`)."""
    timer = Timer(torch, iters=5)
    rs = np.random.RandomState(35)
    c = RCNN
    A = len(c["scales"]) * len(c["ratios"])
    inputs, attrs = proposal_case(rs)
    before = kernels.LAUNCHES["greedy_nms_f64"]
    got, want, ms, cpu_ms = det_op_case(
        torch, "_contrib_MultiProposal", attrs, inputs, timer)
    check(kernels.LAUNCHES["greedy_nms_f64"] > before,
          "MultiProposal on the card launched no NMS kernel")
    # the f32 exp of the box decoder is CUDA's on the card: a box may move
    # by an ulp, and an NMS decision at an IoU within it of the threshold
    # may go the other way; rows are held to 1e-3 pixels, 99% of them
    rows_ok = ((got[0] - want[0]).abs().max(1).values <= 1e-3)
    share = float(rows_ok.float().mean())
    score_err = float((got[1] - want[1]).abs().max())
    log("MultiProposal (%d, %d, %d, %d) -> (%d, 5) rois, %d anchors, pre "
        "6000 / post 300, one NMS launch over %d images of %d boxes: card "
        "%.3f ms, cpu %.1f ms; rows within 1e-3 px of the CPU's: %.4f "
        "(tolerance: 99%%), largest score difference %.3g [%s]"
        % (c["batch"], 2 * A, c["h"], c["w"], got[0].shape[0],
           c["h"] * c["w"] * A, c["batch"], min(6000, c["h"] * c["w"] * A),
           ms, cpu_ms, share, score_err, card))
    check(share >= 0.99 and got[0].dtype == torch.float64,
          "MultiProposal card vs cpu: %.4f of the rows agree" % share)
    nms = proposal_nms(torch, kernels, inputs, attrs, card)
    data = rs.randn(1, c["channels"], c["h"], c["w"]).astype(np.float32)
    rois = rcnn_rois(rs, c["rois"], c["h"], c["w"], c["stride"])
    got, want, ms, cpu_ms = det_op_case(
        torch, "ROIPooling", dict(pooled_size=(c["k"], c["k"]),
                                  spatial_scale=1.0 / c["stride"]),
        [data, rois], timer)
    err = float((got[0] - want[0]).abs().max())
    log("ROIPooling %d ROIs at %dx%d on (1, %d, %d, %d): card %.3f ms, cpu "
        "%.1f ms; largest difference %.3g (tolerance 0: a max) [%s]"
        % (c["rois"], c["k"], c["k"], c["channels"], c["h"], c["w"], ms,
           cpu_ms, err, card))
    check(err == 0, "ROIPooling card vs cpu differs by %.3g" % err)
    ps = rs.randn(1, c["classes"] * c["k"] ** 2, c["h"], c["w"]) \
        .astype(np.float32)
    got, want, ms, cpu_ms = det_op_case(
        torch, "_contrib_PSROIPooling",
        dict(spatial_scale=1.0 / c["stride"], output_dim=c["classes"],
             pooled_size=c["k"]), [ps, rois], timer)
    err = float((got[0] - want[0]).abs().max()
                / want[0].abs().max().clamp(min=1))
    log("PSROIPooling %d ROIs, output_dim %d, k %d on (1, %d, %d, %d): card "
        "%.3f ms, cpu %.1f ms; largest difference %.3g of the largest "
        "magnitude (tolerance 1e-6: float64 integral images summed in "
        "another order) [%s]" % (c["rois"], c["classes"], c["k"],
                                 ps.shape[1], c["h"], c["w"], ms, cpu_ms,
                                 err, card))
    check(err <= 1e-6, "PSROIPooling card vs cpu differs by %.3g" % err)
    C = c["deform_channels"]
    dc = [rs.randn(1, C, c["h"], c["w"]).astype(np.float32),
          (rs.randn(1, 18, c["h"], c["w"]) * 2).astype(np.float32),
          (rs.randn(C, C, 3, 3) * 0.02).astype(np.float32),
          rs.randn(C).astype(np.float32)]
    got, want, ms, cpu_ms = det_op_case(
        torch, "_contrib_DeformableConvolution",
        dict(kernel=(3, 3), pad=(1, 1), num_filter=C), dc, timer)
    err = float((got[0] - want[0]).abs().max()
                / want[0].abs().max().clamp(min=1))
    log("DeformableConvolution 3x3, %d -> %d channels on (1, %d, %d, %d): "
        "card %.3f ms, cpu %.1f ms; largest difference %.3g of the largest "
        "magnitude (tolerance 1e-5: float32 sums of %d products in "
        "another order, TF32 off) [%s]" % (C, C, C, c["h"], c["w"], ms,
                                           cpu_ms, err, 9 * C, card))
    check(err <= 1e-5, "DeformableConvolution card vs cpu differs by %.3g"
          % err)
    del timer
    return nms


# the five conv nets at their full configurations (phase 35b) and input
# sizes; their small parity configurations are torch_cases.MORE_NETS_SMALL
MORE_NETS = (("resnet_v1", dict(num_layers=50), 224),
             ("resnext", dict(num_layers=50), 224),
             ("mobilenet", {}, 224), ("googlenet", {}, 224),
             ("inception_v4", {}, 299))


def more_net_parity(torch, family, card):
    """The net at torch_cases.MORE_NETS_SMALL's configuration and
    MORE_NETS_HW's size, batch 4, from more_net_case's state, on the card
    and on the CPU in f32 (GoogLeNet and Inception-v4 up to their
    classifier's Dropout, whose masks are each device's own draws).  Per
    tensor, each difference is taken relative to the CPU's largest
    magnitude (at least 1).
    * The training forward up to MORE_NETS_TRAIN_CUT: each output and
      new moving statistic within 2e-3, the tolerance
      tests/torch_parity.check_more_net holds the port to the JAX
      package with.
    * Past the cut (Inception-v4's last stage, whose 1x1 maps leave
      BatchNorm 4 values per channel) the training forward is logged,
      beside the CPU's own distance when its data moves by 1e-7
      (relative, about one ulp): what rounding alone does there.  The
      port's BatchNorm, as the reference's, computes in f32 whatever the
      data's dtype, so a float64 run is no witness.
    * The predict forward and gradient (of the outputs' sum): outputs
      within 1e-4, gradients norm-wise within 1e-2, as phase 18's
      imagenet branch (ReLU and max-pool ties)."""
    import torch_cases as tc
    from mxnet_tpu_torch import models
    net = tc.features(getattr(models, family).get_symbol(
        num_classes=5, **tc.MORE_NETS_SMALL[family]))
    hw = tc.MORE_NETS_HW[family]
    params, aux, feed = tc.more_net_case(net, hw)

    def train(sym, dev, feed=feed):
        outs, new, _ = tc.more_net_eval(sym, params, aux, feed, True, dev,
                                        grad=False)
        return outs + new

    def per_tensor(got, want):
        check(len(got) == len(want), "%s: %d tensors where %d"
              % (family, len(got), len(want)))
        return max(float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                   for a, b in zip(got, want))

    cut = tc.MORE_NETS_TRAIN_CUT.get(family)
    sub = net.get_internals()[cut] if cut else net
    held = per_tensor(train(sub, "cuda"), train(sub, "cpu"))
    check(held <= 2e-3, "%s training forward%s: card %.3g from the CPU per "
          "tensor" % (family, " to " + cut if cut else "", held))
    past = ""
    if cut:
        cpu = train(net, "cpu")
        moved = dict(feed, data=feed["data"] * np.float32(1 + 1e-7))
        past = ("; the whole graph: card %.3g from the CPU, the CPU %.3g "
                "from itself with the data moved by 1e-7"
                % (per_tensor(train(net, "cuda"), cpu),
                   per_tensor(train(net, "cpu", moved), cpu)))
    (out_c, _, g_c), (out_h, _, g_h) = (
        tc.more_net_eval(net, params, aux, feed, False, dev)
        for dev in ("cuda", "cpu"))
    out_err = per_tensor(out_c, out_h)
    g_c, g_h = (np.concatenate([g.ravel() for g in gs]) for gs in (g_c, g_h))
    gap = float(np.linalg.norm(g_c - g_h) / np.linalg.norm(g_h))
    log("%s %dx%d batch 4 (%s) card vs cpu: training forward%s %.3g per "
        "tensor (tolerance 2e-3)%s; predict forward and gradient: outputs "
        "%.3g (tolerance 1e-4), gradients %.3g norm-wise (tolerance 1e-2) "
        "[%s]"
        % (family, hw, hw, "the whole graph" if "softmax_label" in feed
           else "to the classifier's Dropout",
           " to " + cut if cut else "", held, past, out_err, gap, card))
    check(out_err <= 1e-4 and gap <= 1e-2, "%s predict card vs cpu: "
          "outputs %.3g, gradients %.3g" % (family, out_err, gap))


def phase_more_nets(torch, kernels, ShardedTrainer, card):
    """The five conv nets: parity at a small size, then one ShardedTrainer
    step each at batch 32 (224x224, Inception-v4 299x299), timed."""
    from mxnet_tpu_torch import models
    for family, _kw, _hw in MORE_NETS:
        more_net_parity(torch, family, card)
    kernels.reset_launches()
    for family, kw, hw in MORE_NETS:
        net = getattr(models, family).get_symbol(num_classes=1000, **kw)
        shapes = {"data": (RESNET_BATCH, 3, hw, hw),
                  "softmax_label": (RESNET_BATCH,)}
        tr = ShardedTrainer(net, lr=0.1, momentum=0.9, wd=1e-4)
        params, mom, aux = tr.init_state(shapes, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = {"data": torch.randn(shapes["data"], generator=gen,
                                     device="cuda"),
                 "softmax_label": torch.randint(
                     0, 1000, (RESNET_BATCH,), generator=gen,
                     device="cuda").float()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2 + 3):
            t0 = time.perf_counter()
            params, mom, aux, loss = tr.step(params, mom, aux, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times[2:])
        flops = train_flops(net, shapes)
        check(np.isfinite(float(loss)), "%s: loss %s" % (family, loss))
        log("%s %s %dx%d batch %d f32 ShardedTrainer step (cudnn.benchmark "
            "off, TF32 off): warm-up %s ms, timed %s ms, median %.2f = %.1f "
            "images/s; %.4f TFLOP per step -> %.3f of the 67 TFLOP/s f32 "
            "peak; peak memory %.2f GB [%s]"
            % (family, kw or "", hw, hw, RESNET_BATCH,
               ", ".join("%.1f" % t for t in times[:2]),
               ", ".join("%.2f" % t for t in times[2:]), med,
               RESNET_BATCH / med * 1e3, flops / 1e12,
               flops / (med / 1e3) / F32_FLOPS_S,
               torch.cuda.max_memory_allocated() / 1e9, card))
        del tr, params, mom, aux, batch
        torch.cuda.empty_cache()
    got = dict(kernels.LAUNCHES)
    check(not any(got.values()), "the conv nets launched a hand-written "
          "kernel: %s" % got)


# ---------------------------------------------------------------------------
# phase 36: sparse storage (row_sparse and CSR arrays, the kvstore's sparse
# push and row_sparse_pull, lazy SGD, LibSVMIter, SparseEmbedding)
# ---------------------------------------------------------------------------

# example/sparse/linear_classification.py's loop at the Criteo Kaggle shape
# of phase 11 (26 fields, a (1,000,000, 64) table each); the embedding lr is
# high because a row's gradient is err / batch * w / fields
WIDE = dict(keys=26, rows=1000000, dim=64, batch=8192, lr=20.0,
            momentum=0.9, lr_w=2.0, zipf=1.2)
WIDE_CHECK = dict(WIDE, rows=100000)       # the bench geometry's rows
# Avazu's hashed width, as MXNet's example/sparse/linear_classification
AVAZU = dict(features=1000000, batch=8192, rows=65536, nnz=(10, 21))
# example/sparse/symbolic_sparse_lr.py's graph at full width
SPARSE_LR = dict(vocab=1000000, dim=16, active=8, batch=8192, classes=2,
                 lr=0.5, momentum=0.9, warm=2, timed=10)


def to_dev(torch, a, dev):
    """A host array on ``dev`` (from pinned memory without blocking on the
    card, so the copy is no host sync)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dev) if dev == "cpu" else \
        t.pin_memory().to(dev, non_blocking=True)


def wide_data(geo, seed):
    """A batch of Zipf-drawn ids, one per field per sample (host int64),
    and 0/1 labels."""
    rs = np.random.RandomState(seed)
    ids = (rs.zipf(geo["zipf"], (geo["batch"], geo["keys"])) - 1) \
        % geo["rows"]
    return ids.astype(np.int64), (rs.rand(geo["batch"]) > 0.5).astype(
        np.float32)


def wide_table(torch, geo, f, gen_dev):
    """Key ``f``'s initial table, N(0, 0.01) from its own generator (so a
    table can be drawn again for the lazy-contract check)."""
    g = torch.Generator(device=gen_dev).manual_seed(36000 + f)
    return torch.randn((geo["rows"], geo["dim"]), generator=g,
                       device=gen_dev) * 0.01


def wide_setup(torch, mx, geo, dev, gen_dev):
    """The store (``kv.create("device")`` on ``dev``) with a table per key
    and lazy momentum SGD, and the dense head ``w``."""
    kv = mx.kv.create("device", device=dev)
    keys = ["field%02d" % f for f in range(geo["keys"])]
    for f, k in enumerate(keys):
        kv.init(k, mx.nd.NDArray(wide_table(torch, geo, f, gen_dev).to(dev)))
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=geo["lr"],
                                      momentum=geo["momentum"],
                                      lazy_update=True))
    w = to_dev(torch, np.random.RandomState(1).normal(
        0, 1.0, geo["dim"]).astype(np.float32), dev)
    return kv, keys, w


def wide_step(torch, mx, sp, kv, keys, geo, w, ids, y, dev, host=None):
    """One step of the loop: ``row_sparse_pull`` of every key's unique ids
    into row_sparse outs, the mean-pooled logistic regression on ``dev``,
    ``embedding_grad`` per key, one list ``push`` (lazy SGD on the
    store), the head's SGD.  Returns the loss as a tensor (no host
    read)."""
    B, K, D = geo["batch"], geo["keys"], geo["dim"]
    ctx = mx.cpu() if dev == "cpu" else mx.gpu(0)
    outs = [sp.zeros_sparse("row_sparse", (geo["rows"], D), ctx=ctx)
            for _ in keys]
    t0 = time.perf_counter()
    kv.row_sparse_pull(keys, out=outs, row_ids=[ids[:, f] for f in range(K)])
    t1 = time.perf_counter()
    ids_dev = to_dev(torch, ids.T, dev)              # (K, B)
    e = torch.zeros((B, D), device=dev)
    for f, o in enumerate(outs):
        e += o._data[torch.searchsorted(o._indices, ids_dev[f])]
    e /= K
    yt = to_dev(torch, y, dev)
    p = torch.sigmoid(e @ w)
    loss = -(yt * torch.log(p + 1e-8) +
             (1 - yt) * torch.log(1 - p + 1e-8)).mean()
    err = (p - yt) / B
    ge = err[:, None] * w[None, :] / K
    grads = [sp.embedding_grad(ids[:, f], mx.nd.NDArray(ge), geo["rows"])
             for f in range(K)]
    t2 = time.perf_counter()
    kv.push(keys, grads)
    t3 = time.perf_counter()
    w -= geo["lr_w"] * (e.t() @ err)
    if host is not None:
        host["pull"].append((t1 - t0) * 1e3)
        host["push"].append((t3 - t2) * 1e3)
    return loss


def wide_parity(torch, mx, sp, card):
    """36a (ii): three steps of the loop at 26 x 100,000 rows on the card
    and on the CPU (its plain versions) from the same tables: touched rows
    within 1e-6 x max(1, |w|), the rest unchanged, losses within 1e-6."""
    geo = WIDE_CHECK
    runs = {}
    for dev in ("cuda", "cpu"):
        kv, keys, w = wide_setup(torch, mx, geo, dev, "cpu")
        losses = []
        for s in range(3):
            ids, y = wide_data(geo, 100 + s)
            losses.append(float(wide_step(torch, mx, sp, kv, keys, geo, w,
                                          ids, y, dev)))
        runs[dev] = (kv, keys, losses)
    touched = [np.unique(np.concatenate([wide_data(geo, 100 + s)[0][:, f]
                                         for s in range(3)]))
               for f in range(geo["keys"])]
    worst, moved = 0.0, 0
    for f, k in enumerate(runs["cuda"][1]):
        got = runs["cuda"][0]._store[k]._handle.cpu()
        want = runs["cpu"][0]._store[k]._handle
        init = wide_table(torch, geo, f, "cpu")
        t = torch.from_numpy(touched[f])
        mask = torch.ones(geo["rows"], dtype=torch.bool)
        mask[t] = False
        check(torch.equal(got[mask], init[mask]) and
              torch.equal(want[mask], init[mask]),
              "36a: a row no step touched moved (key %s)" % k)
        err = ((got[t] - want[t]).abs() /
               want[t].abs().clamp(min=1.0)).max().item()
        worst = max(worst, err)
        moved += int((want[t] != init[t]).any(1).sum())
        check(err <= 1e-6, "36a: key %s on the card %.3g from the CPU "
              "replay (tolerance 1e-6 x max(1, |w|))" % (k, err))
    lc, lh = runs["cuda"][2], runs["cpu"][2]
    check(all(abs(a - b) <= 1e-6 * max(1.0, abs(b)) for a, b in zip(lc, lh)),
          "36a: losses card %s vs CPU %s" % (lc, lh))
    log("36a parity: 3 steps of %d keys x %d x %d, batch %d, card vs the "
        "CPU's plain versions: touched rows within %.3g of max(1, |w|) "
        "(%d rows moved), every other row unchanged; losses card %s, CPU %s "
        "[%s]" % (geo["keys"], geo["rows"], geo["dim"], geo["batch"], worst,
                  moved, ["%.7f" % v for v in lc], ["%.7f" % v for v in lh],
                  card))
    del runs


def wide_kernel_rows(torch, sk, timer, kv, keys, ids, card):
    """B5 and B6 at 36a's shapes: one key's unique ids of a (1,000,000, 64)
    table, as ``row_sparse_pull`` and the lazy SGD give them."""
    table = kv._store[keys[0]]._handle
    uniq = np.unique(ids[:, 0])
    n, D = len(uniq), table.shape[1]
    pos = torch.from_numpy(uniq).cuda()
    pos32 = pos.to(torch.int32)
    rows = torch.randn((n, D), device="cuda")
    t_set, t_plain = table.clone(), table.clone()
    g_k, g_p = sk.embedding_gather(table, pos32), \
        sk.embedding_gather_plain(table, pos32)
    sk.embedding_scatter(t_set, pos32, rows, "set")
    sk.embedding_scatter_plain(t_plain, pos32, rows, "set")
    torch.cuda.synchronize()
    e_g = (g_k - g_p).abs().max().item()
    e_s = (t_set - t_plain).abs().max().item()
    check(e_g == 0 and e_s == 0, "36a: B5 / B6 against their plain versions "
          "at the loop's shape: %g / %g" % (e_g, e_s))
    row_b = D * 4
    b_g, by_g = bound_ms(n * 4 + 2 * n * row_b, 0)
    b_s, by_s = bound_ms(n * 4 + 2 * n * row_b, 0)
    src = "mxnet_tpu_torch/csrc/embedding.cu"
    shape = ("phase 36a: one key's %d unique ids of a (%d, %d) f32 table "
             "(row_sparse_pull, the lazy SGD's weight and momentum rows)"
             % (n, table.shape[0], D))
    out = [{
        "name": "embedding_gather", "route": "cuda", "source": src,
        "replaces": "mxnet_tpu/sparse/kernels.py:117", "shape": shape,
        "launches_per_step": 3 * len(keys), "max_abs_err": e_g,
        "ms": timer(lambda: sk.embedding_gather(table, pos32)),
        "plain_ms": timer(lambda: sk.embedding_gather_plain(table, pos32)),
        "bound_ms": b_g, "bound_by": by_g,
        "library_ms": timer(lambda: torch.index_select(table, 0, pos)),
        "library_call": "torch.index_select(table, 0, ids)",
    }, {
        "name": "embedding_scatter", "route": "cuda", "source": src,
        "replaces": "mxnet_tpu/sparse/kernels.py:175",
        "shape": shape + ", set", "launches_per_step": 2 * len(keys),
        "max_abs_err": e_s,
        "ms": timer(lambda: sk.embedding_scatter(t_set, pos32, rows, "set")),
        "plain_ms": timer(lambda: sk.embedding_scatter_plain(
            t_set, pos32, rows, "set")),
        "bound_ms": b_s, "bound_by": by_s,
        "library_ms": timer(lambda: t_set.index_copy_(0, pos, rows)),
        "library_call": "table.index_copy_(0, ids, rows)",
    }]
    for r in out:
        log("  %-18s %s ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "library_ms=%.4f [%s]" % (r["name"], r["shape"], r["ms"],
                                      r["plain_ms"], r["bound_ms"],
                                      r["bound_by"], r["library_ms"], card))
    del t_set, t_plain
    return out


def wide_full(torch, mx, sp, kernels, sk, card, warm=3, timed=20):
    """36a at full width: 26 keys of (1,000,000, 64) f32 in
    ``kv.create("device")``, lazy momentum SGD, batch 8192 repeated:
    median step ms (CUDA events), host ms in ``row_sparse_pull`` and
    ``push``, host syncs, B5/B6 launches, touched rows per step, idle
    share, peak memory; holds the lazy contract on every untouched row
    and the loss's fall."""
    geo = WIDE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kv, keys, w = wide_setup(torch, mx, geo, "cuda", "cuda")
    torch.cuda.synchronize()
    log("36a: %d tables of (%d, %d) f32 in kv.create('device'): %.2f GB, "
        "%.1f s" % (geo["keys"], geo["rows"], geo["dim"],
                    geo["keys"] * geo["rows"] * geo["dim"] * 4 / 1e9,
                    time.perf_counter() - t0))
    ids, y = wide_data(geo, 36)
    touched = sum(len(np.unique(ids[:, f])) for f in range(geo["keys"]))
    host = {"pull": [], "push": []}
    ev = [torch.cuda.Event(enable_timing=True)]
    ev[0].record()
    kernels.reset_launches()
    syncs0 = sp.HOST_SYNCS["count"]
    losses = []
    for _ in range(warm + timed):
        losses.append(wide_step(torch, mx, sp, kv, keys, geo, w, ids, y,
                                "cuda", host))
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
    torch.cuda.synchronize()
    steps = warm + timed
    got = dict(kernels.LAUNCHES)
    d_syncs = sp.HOST_SYNCS["count"] - syncs0
    K = geo["keys"]
    check(got["embedding_gather"] == 3 * K * steps and
          got["embedding_scatter"] == 2 * K * steps,
          "36a: B5 / B6 launched %d / %d times over %d steps, want %d / %d "
          "(a pull and two update reads per key; two update writes)"
          % (got["embedding_gather"], got["embedding_scatter"], steps,
             3 * K * steps, 2 * K * steps))
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    tt = ms[warm:]
    med = statistics.median(tt)
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            losses.append(wide_step(torch, mx, sp, kv, keys, geo, w, ids, y,
                                    "cuda"))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    synced = [str(c.message)[:80] for c in caught
              if "synchroniz" in str(c.message).lower()
              and "prototype" not in str(c.message)]
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses.append(wide_step(torch, mx, sp, kv, keys, geo, w, ids, y,
                                "cuda"))
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_by_kernel(prof)
    busy = sum(us for us, _ in by_kernel.values()) / 1e3
    peak = torch.cuda.max_memory_allocated()
    lv = [float(v) for v in losses]
    log("36a wide embedding: %d keys x (%d, %d), batch %d, %d touched rows "
        "a step: warm-up %s ms; %d timed steps median %.3f ms (spread "
        "%.3f-%.3f) = %.1f examples/s; host ms a step in row_sparse_pull "
        "%.3f, in push %.3f (medians); B5 %d and B6 %d launches a step; "
        "host reads of device indices %d over %d steps; synchronising "
        "operations in one step under set_sync_debug_mode('warn'): %d%s; "
        "device busy %s ms of the profiled step's %.3f ms: idle share %s; "
        "peak memory %.2f GB [%s]"
        % (K, geo["rows"], geo["dim"], geo["batch"], touched,
           ", ".join("%.1f" % t for t in ms[:warm]), timed, med, min(tt),
           max(tt), geo["batch"] / med * 1e3,
           statistics.median(host["pull"][warm:]),
           statistics.median(host["push"][warm:]), 3 * K, 2 * K, d_syncs,
           steps, len(synced), (" (%s)" % "; ".join(sorted(set(synced))))
           if synced else "", "%.3f" % busy if by_kernel else "not measured",
           prof_ms, "%.3f" % (1 - busy / prof_ms) if by_kernel
           else "not measured", peak / 1e9, card))
    check(all(np.isfinite(lv)) and lv[-1] < lv[0],
          "36a: the loss did not fall on the repeated batch (%.6f -> %.6f)"
          % (lv[0], lv[-1]))
    log("36a loss on the repeated batch %.6f -> %.6f over %d steps [%s]"
        % (lv[0], lv[-1], len(lv) - 1, card))
    # the lazy contract: every row no step touched is bit-equal to its
    # initial value, checked on the card against the table drawn again
    moved = 0
    for f, k in enumerate(keys):
        init = wide_table(torch, geo, f, "cuda")
        cur = kv._store[k]._handle
        mask = torch.ones(geo["rows"], dtype=torch.bool, device="cuda")
        mask[torch.from_numpy(np.unique(ids[:, f])).cuda()] = False
        changed = (cur != init).any(1)
        bad = int((changed & mask).sum())
        moved += int((changed & ~mask).sum())
        check(bad == 0, "36a: %d untouched rows of key %s moved" % (bad, k))
        del init, changed
    log("36a lazy contract: every untouched row of the %d tables bit-equal "
        "to its initial value; %d of the %d touched rows moved [%s]"
        % (K, moved, touched, card))
    timer = Timer(torch)
    rows = wide_kernel_rows(torch, sk, timer, kv, keys, ids, card)
    del timer, kv, w
    torch.cuda.empty_cache()
    return got, rows


def write_libsvm(path, geo, seed):
    """A seeded libsvm file at Avazu's width: ``rows`` lines, 10-20
    hashed feature ids a line (Zipf-skewed), values mostly 1 (one-hot
    categories) and some real ones."""
    rs = np.random.RandomState(seed)
    lo, hi = geo["nnz"]
    with open(path, "w") as f:
        for start in range(0, geo["rows"], 4096):
            lines = []
            for _ in range(min(4096, geo["rows"] - start)):
                k = rs.randint(lo, hi)
                ids = (rs.zipf(1.1, k) * 2654435761) % geo["features"]
                vals = np.where(rs.rand(k) < 0.8, 1.0,
                                np.round(rs.rand(k), 4) + 1e-4)
                lines.append("%d %s" % (rs.randint(0, 2), " ".join(
                    "%d:%g" % kv for kv in zip(ids, vals))))
            f.write("\n".join(lines) + "\n")


def csr_avazu(torch, mx, sp, kernels, card):
    """36b: ``LibSVMIter`` at Avazu's width (1,000,000 features, batch
    8192) over a seeded file of 65,536 rows; per batch ``sparse.dot(csr,
    w)`` and ``dot(csr, g, transpose_a=True)`` on the card against the
    CPU (within 1e-5), cast_storage / sparse_retain round trips and a
    ``.params`` round trip bit-equal; iterator and dot ms, peak memory
    (no dense (8192, 1,000,000) array anywhere)."""
    import shutil
    import tempfile
    geo = AVAZU
    tmp = tempfile.mkdtemp(prefix="chip_smoke_libsvm_")
    try:
        path = os.path.join(tmp, "avazu.libsvm")
        t0 = time.perf_counter()
        write_libsvm(path, geo, 36)
        t_write = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        it = mx.io.LibSVMIter(path, data_shape=(geo["features"],),
                              batch_size=geo["batch"])
        t_parse = time.perf_counter() - t0
        batches, t_next = [], []
        while True:
            t0 = time.perf_counter()
            try:
                b = it.next()
            except StopIteration:
                break
            t_next.append((time.perf_counter() - t0) * 1e3)
            batches.append(b)
        check(len(batches) == geo["rows"] // geo["batch"] and
              all(b.pad == 0 for b in batches),
              "36b: %d batches" % len(batches))
        rs = np.random.RandomState(37)
        w_h = rs.randn(geo["features"], 1).astype(np.float32)
        w_c, w_g = mx.nd.array(w_h, ctx=mx.cpu()), mx.nd.array(w_h,
                                                               ctx=mx.gpu(0))
        worst, dot_ms, nnz = 0.0, [], 0
        kernels.reset_launches()
        for i, b in enumerate(batches):
            c_cpu = b.data[0]
            c_gpu = c_cpu.as_in_context(mx.gpu(0))
            check(c_gpu.stype == "csr", "36b: the batch left CSR on the card")
            nnz += int(c_cpu._data.shape[0])
            g_h = rs.randn(geo["batch"], 1).astype(np.float32)
            g_c, g_g = mx.nd.array(g_h, ctx=mx.cpu()), \
                mx.nd.array(g_h, ctx=mx.gpu(0))
            for ta, rhs_c, rhs_g in ((False, w_c, w_g), (True, g_c, g_g)):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = sp.sparse_dot(c_gpu, rhs_g, transpose_a=ta)
                e.record()
                want = sp.sparse_dot(c_cpu, rhs_c, transpose_a=ta).handle
                got = out.handle.cpu()
                dot_ms.append((ta, s.elapsed_time(e)))
                err = ((got - want).abs().max() /
                       max(1.0, want.abs().max().item())).item()
                worst = max(worst, err)
                check(err <= 1e-5, "36b: batch %d dot(transpose_a=%s) %.3g "
                      "from the CPU" % (i, ta, err))
            if i == 0:
                gw = out                       # dot(csr.T, g): (1M, 1)
                rsp = mx.nd.cast_storage(gw, "row_sparse")
                check(torch.equal(mx.nd.cast_storage(rsp, "default").handle,
                                  gw.handle),
                      "36b: dense -> row_sparse -> dense changed a value")
                feats = np.unique(c_cpu._indices.numpy())[::2]
                kept = mx.nd.sparse_retain(rsp, feats)
                dense_kept = mx.nd._sparse_retain(
                    gw, mx.nd.array(feats.astype(np.float32), ctx=mx.gpu(0)))
                check(torch.equal(torch.from_numpy(kept.asnumpy()),
                                  dense_kept.handle.cpu()),
                      "36b: sparse_retain differs from the dense op")
                c2 = mx.nd.cast_storage(c_gpu, "csr")
                check(all(torch.equal(getattr(c2, a).cpu(),
                                      getattr(c_cpu, a))
                          for a in ("_data", "_indices", "_indptr")),
                      "36b: csr -> csr changed the batch")
                f = os.path.join(tmp, "sparse.params")
                mx.nd.save(f, {"grad": rsp, "batch": c_gpu})
                back = mx.nd.load(f, ctx=mx.gpu(0))
                check(torch.equal(back["grad"]._data, rsp._data) and
                      torch.equal(back["grad"]._indices, rsp._indices) and
                      all(torch.equal(getattr(back["batch"], a),
                                      getattr(c_gpu, a))
                          for a in ("_data", "_indices", "_indptr")),
                      "36b: the .params round trip changed a record")
                log("36b round trips: (1000000, 1) dense -> row_sparse (%d "
                    "rows) -> dense, sparse_retain of %d ids against the "
                    "dense op, csr -> csr, .params of a row_sparse and a "
                    "CSR record (%.1f MB): bit-equal"
                    % (rsp._data.shape[0], len(feats),
                       os.path.getsize(f) / 1e6))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        check(peak < 2e9, "36b: peak memory %.2f GB: a dense batch would be "
              "%.1f GB" % (peak / 1e9, geo["batch"] * geo["features"] * 4 /
                           1e9))
        fw = [m for ta, m in dot_ms if not ta]
        bw = [m for ta, m in dot_ms if ta]
        got = dict(kernels.LAUNCHES)
        log("36b CSR at Avazu's width: %d rows, %.1f nonzeros a row, written "
            "in %.2f s; LibSVMIter parse %.2f s, next() median %.3f ms a "
            "batch of %d; dot(csr, w (1000000, 1)) median %.4f ms, dot(csr, "
            "g, transpose_a=True) median %.4f ms (first call included in "
            "neither: %.4f / %.4f); within %.3g of the CPU; B5 launches %d; "
            "peak memory %.3f GB (a dense batch: %.1f GB) [%s]"
            % (geo["rows"], nnz / (len(batches) * geo["batch"]), t_write,
               t_parse, statistics.median(t_next), geo["batch"],
               statistics.median(fw[1:]), statistics.median(bw[1:]), fw[0],
               bw[0], worst, got["embedding_gather"],
               peak / 1e9, geo["batch"] * geo["features"] * 4 / 1e9, card))
        check(got["embedding_gather"] >= 2 * len(batches),
              "36b: the dots launched B5 %d times over %d batches"
              % (got["embedding_gather"], len(batches)))
        return got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sparse_lr_net(sym, vocab, dim, classes):
    """example/sparse/symbolic_sparse_lr.py's graph."""
    emb = sym.contrib.SparseEmbedding(data=sym.Variable("data"),
                                      weight=sym.Variable("embed_weight"),
                                      input_dim=vocab, output_dim=dim,
                                      name="wide_embedding")
    logits = sym.FullyConnected(sym.mean(emb, axis=1), num_hidden=classes,
                                name="fc")
    return sym.SoftmaxOutput(logits, name="softmax")


def sparse_lr_data(cfg, n, seed):
    """Ids (as the float32 data Module feeds) and the labels of a hidden
    linear model over a hidden embedding."""
    rs = np.random.RandomState(seed)
    proj = rs.normal(0, 1, cfg["dim"]).astype(np.float32)
    feats = rs.randint(0, cfg["vocab"], (n, cfg["active"]))
    hidden = rs.normal(0, 1, (cfg["vocab"], cfg["dim"])).astype(np.float32)
    y = (hidden[feats].mean(1) @ proj > 0).astype(np.float32)
    return feats.astype(np.float32), y


def sparse_row_ids(batch):
    """``sparse_row_id_fn``: the rows of the embedding a batch reads."""
    return {"embed_weight": batch.data[0].asnumpy().astype(np.int64).ravel()}


def sparse_lr_module(mx, cfg, ctx, kv, params=None):
    mod = mx.mod.Module(sparse_lr_net(mx.sym, cfg["vocab"], cfg["dim"],
                                      cfg["classes"]), context=ctx)
    mod.bind([("data", (cfg["batch"], cfg["active"]))],
             [("softmax_label", (cfg["batch"],))])
    if params is None:
        mx.random.seed(36)
        mod.init_params(mx.init.Xavier())
    else:
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                    for k, v in params.items()})
    mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params={
        "learning_rate": cfg["lr"], "momentum": cfg["momentum"]})
    return mod


def sparse_lr_ce(torch, mod, batch):
    mod.forward(batch, is_train=False)
    p = mod.get_outputs()[0].handle
    y = batch.label[0].handle.to(p.device).long()
    return float(-torch.log(p[torch.arange(len(y), device=p.device), y]
                            + 1e-12).mean())


def sparse_lr_parity(torch, mx, card):
    """36c: one step of the classifier at vocab 10,000 (batch 8192) on
    the card and on the CPU from the same parameters, each batch's rows
    pulled by ``sparse_row_id_fn``: every tensor within 1e-5 of its
    largest update plus one float32 rounding of each element (the
    embedding's updates, ~5e-5, lie below its weights' ulps, ~2e-9, so
    the rounding of ``w + update`` alone can differ by an ulp)."""
    cfg = dict(SPARSE_LR, vocab=10000)
    X, Y = sparse_lr_data(cfg, cfg["batch"], 38)
    host = mx.mod.Module(sparse_lr_net(mx.sym, cfg["vocab"], cfg["dim"],
                                       cfg["classes"]), context=mx.cpu())
    host.bind([("data", X.shape)], [("softmax_label", Y.shape)])
    mx.random.seed(36)
    host.init_params(mx.init.Xavier())
    start = {k: v.asnumpy() for k, v in host.get_params()[0].items()}
    after = {}
    for dev, ctx in (("cuda", mx.gpu(0)), ("cpu", mx.cpu())):
        kv = mx.kv.create("device", device=dev)
        mod = sparse_lr_module(mx, cfg, ctx, kv, start)
        batch = next(iter(mx.io.NDArrayIter(X, Y, batch_size=cfg["batch"],
                                            label_name="softmax_label")))
        mod.prepare(batch, sparse_row_id_fn=sparse_row_ids)
        mod.forward_backward(batch)
        mod.update()
        after[dev] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    worst, ulps = 0.0, 0
    for k in start:
        want, got = after["cpu"][k], after["cuda"][k]
        upd = np.abs(want - start[k]).max()
        diff = np.abs(got - want)
        ulp = np.spacing(np.abs(want).astype(np.float32))
        ok = diff <= 1e-5 * upd + ulp
        check(upd > 0 and ok.all(), "36c: %s on the card %.3g from the "
              "CPU, its largest update %.3g" % (k, diff.max(), upd))
        worst = max(worst, float((np.maximum(diff - ulp, 0)).max() / upd))
        ulps += int((diff > 0).sum())
    log("36c parity: one step at vocab %d, batch %d, card vs CPU: every "
        "tensor within 1e-5 of its largest update plus one ulp (beyond the "
        "ulp %.3g of it; %d elements one ulp apart) [%s]"
        % (cfg["vocab"], cfg["batch"], worst, ulps, card))


def sparse_lr_full(torch, mx, sp, kernels, card):
    """36c: ``Module.fit`` of the SparseEmbedding classifier at vocab
    1,000,000, dim 16, 8 ids a row, batch 8192, SGD (lr 0.5, momentum 0.9)
    through ``KVStore("device")`` with ``sparse_row_id_fn``: median step ms
    (CUDA events at each batch end), host ms in ``prepare`` and
    ``update()``, B5/B6 launches, idle share, peak memory; then the loss
    falling on a repeated batch."""
    cfg = SPARSE_LR
    steps = cfg["warm"] + cfg["timed"]
    X, Y = sparse_lr_data(cfg, cfg["batch"] * steps, 39)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kv = mx.kv.create("device")
    mod = sparse_lr_module(mx, cfg, mx.gpu(0), kv)
    host = {"prepare": [], "update": []}
    for name in host:
        def timed_call(*a, _f=getattr(mod, name), _n=name, **k):
            t0 = time.perf_counter()
            out = _f(*a, **k)
            host[_n].append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(mod, name, timed_call)
    ev = []

    def batch_end(param):
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
    it = mx.io.NDArrayIter(X, Y, batch_size=cfg["batch"],
                           label_name="softmax_label")
    kernels.reset_launches()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, kvstore=kv, eval_metric="ce",
            batch_end_callback=batch_end, sparse_row_id_fn=sparse_row_ids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(kernels.LAUNCHES)
    # a prepare per batch after the first: one gather from the dense store
    # and one write into the bound weight
    check(got["embedding_gather"] == steps - 1 and
          got["embedding_scatter"] == steps - 1,
          "36c: B5 / B6 launched %d / %d times over %d batches, want %d "
          "each (one row_sparse_pull a batch after the first)"
          % (got["embedding_gather"], got["embedding_scatter"], steps,
             steps - 1))
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
    tt = ms[cfg["warm"] - 1:]
    med = statistics.median(tt)
    from torch.profiler import ProfilerActivity, profile
    batch = next(iter(mx.io.NDArrayIter(X[:cfg["batch"]], Y[:cfg["batch"]],
                                        batch_size=cfg["batch"],
                                        label_name="softmax_label")))
    ce0 = sparse_lr_ce(torch, mod, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mod.prepare(batch, sparse_row_id_fn=sparse_row_ids)
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_by_kernel(prof)
    busy = sum(us for us, _ in by_kernel.values()) / 1e3
    for _ in range(4):
        mod.prepare(batch, sparse_row_id_fn=sparse_row_ids)
        mod.forward_backward(batch)
        mod.update()
    ce1 = sparse_lr_ce(torch, mod, batch)
    peak = torch.cuda.max_memory_allocated()
    log("36c Module.fit of the SparseEmbedding classifier (vocab %d, dim "
        "%d, %d ids a row, batch %d): fit %.2f s over %d batches; median "
        "step %.3f ms (spread %.3f-%.3f) = %.1f examples/s; host ms a step "
        "in prepare %.3f, in update() %.3f (medians); B5 / B6 %d / %d "
        "launches; device busy %s ms of the profiled step's %.3f ms: idle "
        "share %s; peak memory %.2f GB [%s]"
        % (cfg["vocab"], cfg["dim"], cfg["active"], cfg["batch"], wall,
           steps, med, min(tt), max(tt), cfg["batch"] / med * 1e3,
           statistics.median(host["prepare"]),
           statistics.median(host["update"]), got["embedding_gather"],
           got["embedding_scatter"],
           "%.3f" % busy if by_kernel else "not measured", prof_ms,
           "%.3f" % (1 - busy / prof_ms) if by_kernel else "not measured",
           peak / 1e9, card))
    check(np.isfinite(ce1) and ce1 < ce0, "36c: the cross-entropy did not "
          "fall on the repeated batch (%.6f -> %.6f)" % (ce0, ce1))
    log("36c cross-entropy on one repeated batch %.6f -> %.6f over 5 steps "
        "[%s]" % (ce0, ce1, card))
    del mod, kv
    torch.cuda.empty_cache()
    return got


def phase_sparse(torch, mx, kernels, card):
    """Phase 36: sparse storage on the card (36a the wide-embedding loop,
    36b CSR at Avazu's width, 36c Module.fit of the SparseEmbedding
    classifier); returns each part's launches and the B5/B6 rows."""
    from mxnet_tpu_torch.ndarray import sparse as sp
    from mxnet_tpu_torch.sparse import kernels as sk
    wide_parity(torch, mx, sp, card)
    torch.cuda.empty_cache()
    launches = {}
    launches["wide"], rows = wide_full(torch, mx, sp, kernels, sk, card)
    launches["csr"] = csr_avazu(torch, mx, sp, kernels, card)
    torch.cuda.empty_cache()
    sparse_lr_parity(torch, mx, card)
    launches["module"] = sparse_lr_full(torch, mx, sp, kernels, card)
    return launches, rows


# -- phase 37: data IO, the feed of the three training paths -----------------

# ImageNet's records as example/image_classification/train_imagenet.py:
# 129-136 reads them: JPEGs stored at short side 256 (256x341), quality
# 95, 1000 classes; a random 224x224 crop and mirror, batch 32, no mean
# or std (the script sets none), preprocess_threads = the host's cores.
# Seeded smooth scenes (tools/make_jpeg_fixture.py) stand in for the
# photographs, which are not in the repository.  Each fit runs 13 steps:
# 2 warm-up, 10 timed (CUDA events at batch end), 1 profiled (the first
# fed turn only); fed and in-memory fits take turns.
FEED = dict(records=1280, batch=32, classes=1000, warm=2, timed=10,
            turns=2, rate_batches=8)
# the training check: a fresh Module over the first 64 records (2
# batches, center crop, no mirror) at lr 0.01; the metric's cross-entropy
# of the last epoch must lie the margin below the first's
FEED_CHECK = dict(parts=20, epochs=8, lr=0.01, margin=0.5)
# SSD's records: phase 34's seeded scenes as JPEGs with MXNet's detection
# header, through ImageDetIter and CreateDetAugmenter at SSD's recipe
DET_FEED = dict(records=128, batch=32, hw=300, steps=6, quality=95)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def feed_fixture_tool(here):
    """tools/make_jpeg_fixture.py (the scenes and the fixture's format)."""
    sys.path.insert(0, os.path.join(here, "tools"))
    import make_jpeg_fixture
    return make_jpeg_fixture


def pack_records(mx, prefix, make, n):
    """``make(i)`` -> (label, HWC uint8 image) for i < n, encoded by
    ``recordio.pack_img`` at quality 95 on every core, written to
    prefix.rec / prefix.idx; returns the JPEG bytes."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        label, img = make(i)
        return mx.recordio.pack_img(mx.recordio.IRHeader(0, label, i, 0),
                                    img, quality=95)

    with ThreadPoolExecutor(os.cpu_count()) as ex:
        recs = list(ex.map(one, range(n)))
    w = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, r in enumerate(recs):
        w.write_idx(i, r)
    w.close()
    return sum(len(r) for r in recs)


def decoder_check(mx, here, tmp, card):
    """The decoders this host has against the committed fixture (16 JPEGs
    at 256x341, quality 95, and the JAX package's PIL pixels): PIL's
    ``imdecode`` directly, and the native backend through its iterator
    at the fixture's own size with no crop, mirror or normalisation.
    Tolerance: 3 levels of 255 (libjpeg-turbo on both sides decodes the
    same stream bit for bit; other IDCTs and chroma upsampling differ by
    a few levels).  Returns (the decoder's name, why the native plane
    cannot build here or None)."""
    import PIL
    from PIL import features
    from mxnet_tpu_torch.io import native
    fx = np.load(os.path.join(here, "tests", "fixtures", "jpeg_fixture.npz"))
    jpeg, off, pix = fx["jpeg"], fx["offsets"], fx["pixels"]
    streams = [jpeg[off[i]:off[i + 1]].tobytes() for i in range(len(pix))]
    mx.image.imdecode(streams[0])
    t0 = time.perf_counter()
    got = [mx.image.imdecode(s).asnumpy() for s in streams]
    dec_ms = (time.perf_counter() - t0) / len(streams) * 1e3
    pil_err = max(int(np.abs(g.astype(int) - p).max())
                  for g, p in zip(got, pix))
    name = "PIL %s (libjpeg-turbo %s)" % (PIL.__version__,
                                          features.version("libjpeg_turbo"))
    why = native.why_not_native()
    nat = "not built on this host: %s" % why
    if why is None:
        prefix = os.path.join(tmp, "fixture")
        w = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                          "w")
        for i, s in enumerate(streams):
            w.write_idx(i, mx.recordio.pack(
                mx.recordio.IRHeader(0, float(i), i, 0), s))
        w.close()
        it = mx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                   data_shape=(3,) + pix.shape[1:3],
                                   batch_size=len(pix))
        check(it._native is not None, "the native plane builds here but "
              "ImageRecordIter chose the Python path")
        nat_err = float(np.abs(it.next().data[0].asnumpy()
                               - pix.transpose(0, 3, 1, 2)).max())
        nat = "max |diff| %g levels" % nat_err
        check(nat_err <= 3, "the native decode is %g levels off the "
              "fixture" % nat_err)
    log("37 decoders: imdecode is %s: %.2f ms a 256x341 JPEG, max |diff| "
        "%d levels against the fixture's pixels (tolerance 3); native "
        "libjpeg backend: %s [%s]" % (name, dec_ms, pil_err, nat, card))
    check(pil_err <= 3, "imdecode is %d levels off the fixture" % pil_err)
    return name, why


def record_iter(mx, prefix, native_io, **kw):
    """train_imagenet.py's ImageRecordIter over prefix.rec, on the backend
    asked for ("1"/"0") or by the JAX package's rule (None)."""
    args = dict(path_imgrec=prefix + ".rec", data_shape=(3, 224, 224),
                batch_size=FEED["batch"], shuffle=True, rand_crop=True,
                rand_mirror=True, preprocess_threads=os.cpu_count())
    args.update(kw)
    old = os.environ.pop("MXNET_TPU_NATIVE_IO", None)
    if native_io is not None:
        os.environ["MXNET_TPU_NATIVE_IO"] = native_io
    try:
        return mx.io.ImageRecordIter(**args)
    finally:
        os.environ.pop("MXNET_TPU_NATIVE_IO", None)
        if old is not None:
            os.environ["MXNET_TPU_NATIVE_IO"] = old


def iterator_rates(mx, prefix, backends, card):
    """The iterator alone: images/s and host ms per next() over
    FEED["rate_batches"] batches after one, per backend and thread
    count."""
    out = {}
    for backend in backends:
        for threads in sorted({1, 4, os.cpu_count()}):
            it = record_iter(mx, prefix, "1" if backend == "native" else "0",
                             preprocess_threads=threads)
            it.next()
            t0 = time.perf_counter()
            for _ in range(FEED["rate_batches"]):
                it.next()
            s = time.perf_counter() - t0
            out[(backend, threads)] = (FEED["rate_batches"] * FEED["batch"]
                                       / s, s / FEED["rate_batches"] * 1e3)
            del it
    log("37a ImageRecordIter alone (224x224 random crop and mirror, batch "
        "%d, %d batches after one): %s [%s]"
        % (FEED["batch"], FEED["rate_batches"], "; ".join(
            "%s %d thread(s) %.0f images/s (%.1f ms a next())"
            % (b, t, r, ms) for (b, t), (r, ms) in out.items()), card))
    return out


# the host-side range that marks the profiled fed step in 37a's trace
FED_STEP_MARK = "chip_smoke profiled fed step"


def profile_copies(prof, trace_path):
    """(device busy ms, every host-to-device copy as (kind, bytes, ms,
    whether it overlapped a kernel)) of the step that FED_STEP_MARK spans,
    read from the trace the profiler exports to ``trace_path``: its copies
    carry their bytes there, and its device events are kept only where
    they overlap the mark, clipped to it (the tracer's warm-up step is in
    the trace too).  The mark is on the host's clock and the device's
    events are converted to it: the step's first copy, issued ~0.2 ms
    after the mark opens onto an idle card, can be placed just before it,
    so an event counts by its overlap, not its start."""
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as fh:
        events = [ev for ev in json.load(fh).get("traceEvents", [])
                  if ev.get("ph") == "X"]
    marks = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
             for ev in events if ev.get("name") == FED_STEP_MARK
             and not ev.get("cat", "").startswith("gpu")]
    check(len(marks) == 1, "the profiled fed step's trace holds %d marks"
          % len(marks))
    lo, hi = marks[0]
    kernels_iv, copies, busy = [], [], 0.0
    for ev in events:
        cat = ev.get("cat")
        a = float(ev["ts"])
        b = a + float(ev.get("dur", 0))
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") \
                or b < lo or a > hi:
            continue
        busy += (min(b, hi) - max(a, lo)) / 1e3
        if cat == "kernel":
            kernels_iv.append((a, b))
        elif ev.get("name", "").startswith("Memcpy HtoD"):
            copies.append((ev["name"], int(ev.get("args", {}).get(
                "bytes", -1)), (a, b)))
    return busy, [(name, nbytes, (b - a) / 1e3,
                   any(a < d and c < b for c, d in kernels_iv))
                  for name, nbytes, (a, b) in copies]


def feed_resnet(torch, mx, prefix, backends, card):
    """37a: ResNet-50 f32 through Module.fit fed by ImageRecordIter, in
    turns with the same Module fed by NDArrayIter over batches already
    decoded; the bound batch against the host batch; the profiled step's
    idle share and copies; the training check."""
    from mxnet_tpu_torch.models import resnet
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    f = FEED
    # the timed steps, then one step of the profiler's warm-up and the
    # profiled step
    steps = f["warm"] + f["timed"] + 2
    it = record_iter(mx, prefix, None)
    chosen = "native" if it._native is not None else "python"
    check(chosen == backends[-1], "ImageRecordIter chose the %s backend "
          "where %s builds" % (chosen, backends[-1]))
    # the in-memory turns' batches: 13 of the iterator's own, decoded once
    xs, ys = [], []
    for _ in range(steps):
        b = it.next()
        xs.append(b.data[0].asnumpy())
        ys.append(b.label[0].asnumpy())
    it.reset()
    mem = mx.io.NDArrayIter(np.concatenate(xs), np.concatenate(ys),
                            batch_size=f["batch"], label_name="softmax_label")
    host_next = []
    orig_next = it.next

    def timed_next():
        t0 = time.perf_counter()
        try:
            return orig_next()
        finally:
            host_next.append((time.perf_counter() - t0) * 1e3)

    it.next = timed_next
    fed = mx.io.ResizeIter(it, steps)
    torch.backends.cudnn.benchmark = True
    net = resnet.get_symbol(**RESNET50)
    mod = mx.mod.Module(net)
    kv = mx.kv.create("device")
    params = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
              "rescale_grad": 1.0 / f["batch"]}
    init = mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                          magnitude=2)
    mx.random.seed(0)
    state = {}

    def fit(train, tag, first):
        ev = []

        def on_batch(p):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.append(e)
            if first and len(ev) == steps - 2:
                # the tracer warms up over one step, so that it records
                # from the profiled step's first operation, its batch copy
                state["prof"] = profile(
                    activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA],
                    schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
                state["prof"].__enter__()
            elif first and len(ev) == steps - 1:
                torch.cuda.synchronize()
                state["prof"].step()
                state["mark"] = record_function(FED_STEP_MARK)
                state["mark"].__enter__()
                state["t0"] = time.perf_counter()
            elif first and len(ev) == steps:
                torch.cuda.synchronize()
                state["wall"] = (time.perf_counter() - state["t0"]) * 1e3
                state["mark"].__exit__(None, None, None)
                state["prof"].step()
                state["prof"].__exit__(None, None, None)
            if tag == "fed" and len(ev) == steps:
                bound = mod._exec_group.execs[0].arg_dict["data"]
                state["bound_equal"] = bool(np.array_equal(
                    bound.asnumpy(), p.locals["batch"].data[0].asnumpy()))

        mod.fit(train, kvstore=kv, optimizer="sgd",
                optimizer_params=dict(params), initializer=init,
                eval_metric=mx.metric.CrossEntropy(),
                batch_end_callback=on_batch, num_epoch=1)
        torch.cuda.synchronize()
        check(len(ev) == steps, "%s fit ran %d steps" % (tag, len(ev)))
        return [a.elapsed_time(b) for a, b in
                zip(ev[f["warm"] - 1:f["warm"] + f["timed"] - 1],
                    ev[f["warm"]:f["warm"] + f["timed"]])]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    turns = {"fed": [], "memory": []}
    for k in range(f["turns"]):
        turns["fed"].append(fit(fed, "fed", k == 0))
        turns["memory"].append(fit(mem, "memory", False))
    peak = torch.cuda.max_memory_allocated()
    med = {tag: [statistics.median(ms) for ms in runs]
           for tag, runs in turns.items()}
    busy, copies = profile_copies(state["prof"], os.path.join(
        os.path.dirname(prefix), "fed_step_trace.json"))
    batch_bytes = f["batch"] * 3 * 224 * 224 * 4
    data_copy = [c for c in copies if c[1] == batch_bytes]
    log("37a ResNet-50 NCHW 224x224 batch %d f32 through Module.fit "
        "(KVStore('device'), SGD lr 0.1 momentum 0.9 wd 1e-4; cuDNN, TF32 "
        "off), fed by ImageRecordIter (%s backend, %d decode threads, "
        "each batch in fresh pinned buffers) in turns with NDArrayIter "
        "over decoded "
        "batches: median step ms (CUDA events at batch end, steps %d-%d) "
        "fed %s, in memory %s; the feed costs %.2f ms a step (%.1f vs "
        "%.1f images/s) [%s]"
        % (f["batch"], chosen, os.cpu_count(), f["warm"] + 1,
           f["warm"] + f["timed"],
           " / ".join("%.2f" % m for m in med["fed"]),
           " / ".join("%.2f" % m for m in med["memory"]),
           statistics.median(med["fed"]) - statistics.median(med["memory"]),
           f["batch"] / statistics.median(med["fed"]) * 1e3,
           f["batch"] / statistics.median(med["memory"]) * 1e3, card))
    log("  fed step times: %s; host ms in next() inside fit: median %.2f "
        "(max %.2f); profiled fed step %d: device busy %.2f ms of %.2f ms, "
        "idle share %.3f; its host-to-device copies: %s; peak memory %.2f "
        "GB [%s]"
        % (" | ".join(", ".join("%.1f" % x for x in ms)
                      for ms in turns["fed"]),
           statistics.median(host_next), max(host_next), steps, busy,
           state["wall"], 1 - busy / state["wall"],
           "; ".join("%s %d bytes %.3f ms (%.1f GB/s), %s a kernel"
                     % (name, nb, ms, nb / ms / 1e6 if ms else 0.0,
                        "overlapping" if ov else "not overlapping")
                     for name, nb, ms, ov in copies) or "none recorded",
           peak / 1e9, card))
    check(state.get("bound_equal"), "the bound data array differs from "
          "the iterator's host batch")
    check(0 < busy <= state["wall"], "the profiled fed step's device busy "
          "time %.2f ms is not within its %.2f ms" % (busy, state["wall"]))
    check(len(data_copy) == 1, "the profiled fed step holds %d copies of "
          "the %d-byte data batch (its copies: %s)"
          % (len(data_copy), batch_bytes, copies))
    check("Pinned -> Device" in data_copy[0][0], "the fed step's data "
          "batch went up as %r, not from pinned memory" % data_copy[0][0])
    del mod, kv
    torch.cuda.empty_cache()
    # the training check: a fresh Module, the first 64 records, no random
    # augmentation, lr 0.01
    c = FEED_CHECK
    small = record_iter(mx, prefix, None, shuffle=False, rand_crop=False,
                        rand_mirror=False, num_parts=c["parts"],
                        part_index=0)
    ces = []
    metric = mx.metric.CrossEntropy()
    mod = mx.mod.Module(net)
    mx.random.seed(0)
    mod.fit(small, kvstore=mx.kv.create("device"), optimizer="sgd",
            optimizer_params={"learning_rate": c["lr"], "momentum": 0.9,
                              "wd": 1e-4, "rescale_grad": 1.0 / f["batch"]},
            initializer=init, eval_metric=metric,
            epoch_end_callback=lambda *a: ces.append(metric.get()[1]),
            num_epoch=c["epochs"])
    log("37a training check: a fresh Module over the first %d records "
        "(center crop, no mirror) at lr %g: cross-entropy by epoch %s; "
        "must fall by %g [%s]"
        % (f["records"] // c["parts"], c["lr"],
           ", ".join("%.3f" % x for x in ces), c["margin"], card))
    check(np.all(np.isfinite(ces)) and ces[-1] <= ces[0] - c["margin"],
          "37a: the fed ResNet-50 did not learn its 64 records")
    del mod
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    return med


def native_agreement(mx, prefix, card):
    """Where the native plane builds: both backends on the deterministic
    configuration (center crop, mean and std) within the JAX test's bound
    (tests/test_record_iter.py: 2/255 scaled by the std)."""
    kw = dict(shuffle=False, rand_crop=False, rand_mirror=False,
              mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
              std_g=57.12, std_b=57.375, num_parts=FEED_CHECK["parts"],
              part_index=0)
    got = {}
    for backend in ("1", "0"):
        it = record_iter(mx, prefix, backend, **kw)
        got[backend] = np.concatenate([b.data[0].asnumpy() for b in it])
    err = float(np.abs(got["1"] - got["0"]).max())
    bound = 2.0 / 57.12 + 1e-5
    log("37a native vs Python backend, %d records, center crop, mean and "
        "std: max |diff| %.6f (bound %.6f) [%s]"
        % (len(got["0"]), err, bound, card))
    check(err < bound, "the backends disagree by %g" % err)


class CudaProbe:
    """A dataset that loads and transforms its base's item, then gives
    the worker's ``torch.cuda.is_initialized()`` and pid."""

    def __init__(self, base, n):
        self.base, self.n = base, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import torch
        self.base[i]
        return np.array([float(torch.cuda.is_initialized()),
                         float(os.getpid())])


def feed_gluon(torch, mx, prefix, card):
    """37b: ImageRecordDataset over 37a's records with RandomResizedCrop,
    flip, ToTensor and Normalize through DataLoader's worker processes
    (and threads), feeding 31c's resnet50_v1 and Trainer in turns with
    31c's in-memory batch."""
    f = FEED
    T = mx.gluon.data.vision.transforms
    ds = mx.gluon.data.vision.ImageRecordDataset(prefix + ".rec") \
        .transform_first(T.Compose([T.RandomResizedCrop(224),
                                    T.RandomFlipLeftRight(), T.ToTensor(),
                                    T.Normalize(IMAGENET_MEAN,
                                                IMAGENET_STD)]))
    workers = min(8, os.cpu_count())

    def loader(tw, dataset=ds):
        return mx.gluon.data.DataLoader(dataset, batch_size=f["batch"],
                                        shuffle=True, last_batch="discard",
                                        num_workers=workers,
                                        thread_workers=tw)

    rates = {}
    for tw in (False, True):
        ld = loader(tw)
        batches = iter(ld)
        next(batches)
        t0 = time.perf_counter()
        for _ in range(f["rate_batches"]):
            next(batches)
        rates["threads" if ld._thread_workers else "processes"] = \
            f["rate_batches"] * f["batch"] / (time.perf_counter() - t0)
        batches.close()
    probe = np.concatenate([b.asnumpy() for b in mx.gluon.data.DataLoader(
        CudaProbe(ds, 4 * workers), batch_size=4, num_workers=workers,
        thread_workers=False)])
    pids = set(probe[:, 1].astype(int))
    log("37b DataLoader alone (batch %d, %d workers, RandomResizedCrop "
        "224, flip, ToTensor, Normalize): %s; %d worker process(es) "
        "reported torch.cuda.is_initialized(): %s [%s]"
        % (f["batch"], workers, ", ".join("%s %.0f images/s" % kv_
                                          for kv_ in rates.items()),
           len(pids), sorted(set(bool(v) for v in probe[:, 0])), card))
    check(not probe[:, 0].any() and os.getpid() not in pids,
          "a DataLoader worker initialised CUDA")
    torch.backends.cudnn.benchmark = True
    rs = np.random.RandomState(0)
    X = mx.nd.array(rs.randn(f["batch"], 3, 224, 224).astype(np.float32),
                    ctx=mx.gpu(0))
    Y = mx.nd.array(rs.randint(0, 1000, f["batch"]).astype(np.float32),
                    ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    mx.random.seed(0)
    net = gluon_resnet50_net(mx, X)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-4})
    steps = f["warm"] + f["timed"] + 1
    losses = []

    def run(tag):
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()
        source = iter(loader(False)) if tag == "fed" else None
        for _ in range(steps):
            if source is None:
                x, y = X, Y
            else:
                xb, yb = next(source)
                x = xb.as_in_context(mx.gpu(0))
                y = yb.as_in_context(mx.gpu(0)).astype(np.float32)
            loss = gluon_step(mx, net, trainer, loss_fn, x, y, f["batch"])
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.append(e)
        if source is not None:
            source.close()
        torch.cuda.synchronize()
        losses.append(float(loss.asnumpy().mean()))
        return [a.elapsed_time(b) for a, b in
                zip(ev[f["warm"]:f["warm"] + f["timed"]],
                    ev[f["warm"] + 1:f["warm"] + f["timed"] + 1])]

    med = {"fed": [], "memory": []}
    for _ in range(f["turns"]):
        for tag in ("fed", "memory"):
            med[tag].append(statistics.median(run(tag)))
    log("37b Gluon resnet50_v1 224x224 batch %d f32 (hybridized; Trainer "
        "sgd lr 0.1 momentum 0.9 wd 1e-4) fed by the DataLoader's %d "
        "worker processes, in turns with 31c's batch on the card: median "
        "step ms fed %s, in memory %s (%.1f vs %.1f images/s); last "
        "losses %s [%s]"
        % (f["batch"], workers, " / ".join("%.2f" % m for m in med["fed"]),
           " / ".join("%.2f" % m for m in med["memory"]),
           f["batch"] / statistics.median(med["fed"]) * 1e3,
           f["batch"] / statistics.median(med["memory"]) * 1e3,
           ", ".join("%.3f" % x for x in losses), card))
    check(np.all(np.isfinite(losses)), "37b: a non-finite loss")
    del net, trainer
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    return med, rates


def feed_ssd(torch, mx, kernels, tmp, card):
    """37c: 128 of phase 34's seeded scenes as JPEGs with MXNet's
    detection header, through ImageDetIter at SSD's recipe into phase
    34's Module.fit for 6 steps."""
    import torch_cases as tc
    from mxnet_tpu_torch.models import ssd
    d = DET_FEED
    X, Y = tc.ssd_scenes(d["records"], d["hw"], SSD_DATA["rows"],
                         SSD["num_classes"], 0, max_obj=SSD_DATA["max_obj"])

    def make(i):
        rows = Y[i][Y[i][:, 0] >= 0]
        img = np.clip(np.round((X[i].transpose(1, 2, 0) + 0.9) / 1.8 * 255),
                      0, 255).astype(np.uint8)
        return np.concatenate([[2.0, 5.0], rows.ravel()]), img

    prefix = os.path.join(tmp, "ssd")
    nbytes = pack_records(mx, prefix, make, d["records"])
    kw = dict(batch_size=d["batch"], data_shape=(3, d["hw"], d["hw"]),
              path_imgrec=prefix + ".rec", rand_crop=0.5, rand_pad=0.5,
              rand_mirror=True, mean=True, std=True, shuffle=True)
    it = mx.image.ImageDetIter(**kw)
    t0 = time.perf_counter()
    n = 0
    for b in it:
        lab = b.label[0].asnumpy()
        n += d["batch"] - b.pad
    rate = n / (time.perf_counter() - t0)
    it.reset()
    shape = it.provide_label[0].shape
    check(lab.shape == shape and shape[2] == 5
          and shape[1] == int((Y[:, :, 0] >= 0).sum(1).max()),
          "ImageDetIter's label is %s, provide_label %s" % (lab.shape, shape))
    pad_rows = lab[:, :, 0] < 0
    check((lab[pad_rows] == -1).all() and pad_rows.any()
          and (~pad_rows).any(1).all(),
          "ImageDetIter's -1 padding is wrong")
    mod = mx.mod.Module(ssd.get_symbol_train(**SSD), data_names=("data",),
                        label_names=("label",))
    ev = []

    def on_batch(p):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev.append(e)

    torch.backends.cudnn.benchmark = True
    mx.random.seed(0)
    before = kernels.LAUNCHES["greedy_nms_f64"]
    metric = mx.metric.Loss(output_names=["loc_loss_output"], label_names=[])
    mod.fit(mx.io.ResizeIter(it, d["steps"]), optimizer="sgd",
            optimizer_params=dict(SSD_SGD), initializer=mx.init.Xavier(),
            eval_metric=metric, batch_end_callback=on_batch, num_epoch=1)
    torch.cuda.synchronize()
    nms = kernels.LAUNCHES["greedy_nms_f64"] - before
    ms = [a.elapsed_time(b) for a, b in zip(ev[1:-1], ev[2:])]
    loc = metric.get()[1]
    log("37c SSD 300x300 batch %d through Module.fit fed by ImageDetIter "
        "(%d records, %.1f KB a JPEG; rand_crop 0.5, rand_pad 0.5, mirror, "
        "ImageNet mean and std; label %s padded with -1): the iterator "
        "alone %.0f images/s (one thread, as the JAX package's); steps "
        "3-%d %s ms, median %.2f ms (%.1f images/s); %d NMS launches; "
        "loc loss %.4f [%s]"
        % (d["batch"], d["records"], nbytes / d["records"] / 1e3, shape,
           rate, d["steps"], ", ".join("%.1f" % x for x in ms),
           statistics.median(ms), d["batch"] / statistics.median(ms) * 1e3,
           nms, loc, card))
    check(len(ev) == d["steps"] and nms == d["steps"],
          "37c ran %d steps with %d NMS launches" % (len(ev), nms))
    check(np.isfinite(loc), "37c: a non-finite loss")
    del mod
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    return statistics.median(ms), rate


def phase_data_io(torch, mx, kernels, here, card):
    """Phase 37: the decoders against the fixture, then 37a-c."""
    import tempfile
    fx = feed_fixture_tool(here)
    with tempfile.TemporaryDirectory() as tmp:
        decoder, why = decoder_check(mx, here, tmp, card)
        prefix = os.path.join(tmp, "imagenet")
        rs = np.random.RandomState(37)
        seeds = rs.randint(0, 2 ** 31 - 1, FEED["records"])
        labels = rs.randint(0, FEED["classes"], FEED["records"])
        t0 = time.perf_counter()
        nbytes = pack_records(mx, prefix, lambda i: (
            float(labels[i]), fx.scene(np.random.RandomState(seeds[i]))),
            FEED["records"])
        log("37a records: %d seeded scenes at 256x341, JPEG quality 95, "
            "%.1f KB a record, %d classes, written in %.1f s; decoder %s; "
            "native libjpeg backend %s [%s]"
            % (FEED["records"], nbytes / FEED["records"] / 1e3,
               FEED["classes"], time.perf_counter() - t0, decoder,
               "builds here" if why is None else "not built: " + why, card))
        backends = ["python"] + (["native"] if why is None else [])
        iterator_rates(mx, prefix, backends, card)
        if why is None:
            native_agreement(mx, prefix, card)
        feed_resnet(torch, mx, prefix, backends, card)
        feed_gluon(torch, mx, prefix, card)
        feed_ssd(torch, mx, kernels, tmp, card)


# -- phase 38: data parallelism across processes ------------------------------
#
# 38a: MXNet's own distributed path, `Module.fit(kvstore="dist_sync")` with
# 2-bit compression, GPT-2-small (TRAIN) at batch 8 a rank in two ranks
# started by tools/launch.py; 38b: the dp / ZeRO ShardedTrainer on the same
# LM at global batch 16; 38c: the recommender at the Criteo shape over a dp
# mesh; 38d: ResNet-50 through a Module over two contexts in one process.
# Two ranks may share this card only where the backend allows it: NCCL
# refuses two ranks of one communicator on one device ("Duplicate GPU
# detected"), gloo carries CUDA tensors through the host.  38a runs on
# gloo then; 38b and 38c need NCCL across two ranks and run the same code
# at dp 1 over a one-rank NCCL group where the card is alone.
DIST_A = dict(batch=8, steps=3, threshold=0.5, lr=1e-4, momentum=0.9,
              seed=38)
DIST_B = dict(batch=16, steps=3, lr=1e-4, momentum=0.9)
DIST_C = dict(steps=2)
DIST_D = dict(batch=32, steps=2, lr=0.01, momentum=0.9)
DIST_TIMEOUT = 360
FLASH_B12 = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")


def dist_probe(here, backend, timeout=150, n=2):
    """tools/torch_dist_probe.py over ``n`` ranks of ``backend``: which
    collectives they can run on CUDA tensors (the ``PROBE`` line)."""
    out = run_gang(here, n, [os.path.join(here, "tools",
                                          "torch_dist_probe.py"), backend],
                   backend, timeout)
    for line in out.splitlines():
        if line.startswith("PROBE "):
            return json.loads(line[len("PROBE "):])
    fail("the %s probe printed no PROBE line:\n%s" % (backend, out[-2000:]))


def run_gang(here, n, argv, backend, timeout=DIST_TIMEOUT):
    """``python tools/launch.py -n N --dist-device cuda`` over ``argv``
    (a script and its arguments) with ``MXNET_TPU_DIST_BACKEND``; every
    process of the gang is killed at ``timeout``; fails unless every rank
    exits 0.  Returns the gang's standard output."""
    import signal
    cmd = [sys.executable, os.path.join(here, "tools", "launch.py"), "-n",
           str(n), "--dist-device", "cuda", "--env",
           "MXNET_TPU_DIST_BACKEND=" + backend, sys.executable] + list(argv)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail("%s: the gang of %d did not end in %d s:\n%s"
             % (argv[-2:], n, timeout, err[-3000:]))
    check(proc.returncode == 0, "%s: the gang of %d exited %d:\n%s\n%s"
          % (argv[-2:], n, proc.returncode, out[-2000:], err[-4000:]))
    return out


def dist_phase(here, n, worker, backend, tmp, timeout=DIST_TIMEOUT):
    """Run ``chip_smoke.py --dist-worker WORKER`` in a gang of ``n``;
    returns each rank's result (a JSON file the rank writes)."""
    out = run_gang(here, n, [os.path.join(here, "chip_smoke.py"),
                             "--dist-worker", worker, tmp], backend,
                   timeout)
    for line in out.splitlines():
        log("  | " + line)
    res = []
    for r in range(n):
        with open(os.path.join(tmp, "%s.r%d.json" % (worker, r))) as f:
            res.append(json.load(f))
    return res


def digest(arrays):
    """sha256 of each host array's bytes, by name."""
    import hashlib
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in sorted(arrays.items())}


def dist_lm_rows(step, rank, world, batch):
    lo = (step * world + rank) * batch
    return slice(lo, lo + batch)


def dist_lm_setup(mx, get_symbol):
    """38a's net, seeded parameters and global data."""
    cfg, A = TRAIN, DIST_A
    B, T = A["batch"], cfg["seq_len"]
    net = get_symbol(**cfg)
    start = module_params(net, {"data": (B, T), "softmax_label": (B, T)},
                          A["seed"])
    world = 2
    rs = np.random.RandomState(A["seed"] + 1)
    shape = (A["steps"] * world * B, T)
    X = rs.randint(0, cfg["vocab_size"], shape).astype(np.float32)
    Y = rs.randint(0, cfg["vocab_size"], shape).astype(np.float32)
    return net, start, X, Y


def worker_38a(torch, parallel, here):
    """One rank of 38a: Module.fit over this rank's rows of each global
    batch through ``dist_sync`` with 2-bit compression."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.transformer import get_symbol
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import audit
    A = DIST_A
    r, n = parallel.rank(), parallel.world_size()
    net, start, X, Y = dist_lm_setup(mx, get_symbol)
    rows = np.concatenate([np.arange(X.shape[0])[dist_lm_rows(
        i, r, n, A["batch"])] for i in range(A["steps"])])
    it = mx.io.NDArrayIter(X[rows], Y[rows], batch_size=A["batch"])
    mod = mx.mod.Module(net, context=mx.gpu(torch.cuda.current_device()),
                        compression_params={"type": "2bit",
                                            "threshold": A["threshold"]})
    kv = mx.kv.create("dist_sync")
    host = []

    def on_batch(_p):
        torch.cuda.synchronize()
        host.append(time.perf_counter())

    audit.clear_collective_log()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    host.append(time.perf_counter())
    mod.fit(it, kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": A["lr"],
                              "momentum": A["momentum"]},
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in start.items()},
            eval_metric=mx.metric.Perplexity(ignore_label=None),
            batch_end_callback=on_batch, num_epoch=1)
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    push = [e for e in audit.collective_log()
            if e["tag"].startswith("KVStoreDist.push")]
    args, _ = mod.get_params()
    return {"launches": got, "digest": digest({k: v.asnumpy() for k, v in
                                               args.items()}),
            "step_ms": [(b - a) * 1e3 for a, b in zip(host, host[1:])],
            "push_bytes": sum(e["bytes"] for e in push) / A["steps"],
            "push_calls": len(push) / A["steps"],
            "keys": len(mod._exec_group.param_names),
            "params": sum(int(np.prod(v.shape)) for v in start.values()),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "backend": parallel.backend(), "world": n}


def two_bit_sum_reference(torch, mx, kv_mod, get_symbol, world):
    """One process: each of 38a's steps runs every rank's batch through
    the port's executor, compresses each rank's gradients with that
    rank's residuals (B7), sums the compressed values and applies the
    store's SGD update.  Returns the digests of the final weights."""
    A = DIST_A
    B, T = A["batch"], TRAIN["seq_len"]
    net, start, X, Y = dist_lm_setup(mx, get_symbol)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind([("data", (B, T))], [("softmax_label", (B, T))])
    mod.init_params(initializer=None, arg_params={
        k: mx.nd.array(v, ctx=mx.cpu()) for k, v in start.items()})
    ex = mod._exec_group.execs[0]
    names = mod._exec_group.param_names
    opt = mx.optimizer.create("sgd", sym=net,
                              param_idx2name=dict(enumerate(names)),
                              learning_rate=A["lr"],
                              momentum=A["momentum"],
                              rescale_grad=1.0 / (B * world))
    upd = mx.optimizer.get_updater(opt)
    weights = {k: mx.nd.NDArray(ex.arg_dict[k]._handle.clone())
               for k in names}
    comps = [kv_mod._TwoBitCompressor(A["threshold"]) for _ in range(world)]
    for i in range(A["steps"]):
        total = None
        for r in range(world):
            sl = dist_lm_rows(i, r, world, B)
            for k in names:
                ex.arg_dict[k]._handle.copy_(weights[k]._handle)
            ex.arg_dict["data"]._handle.copy_(torch.from_numpy(X[sl]))
            ex.arg_dict["softmax_label"]._handle.copy_(
                torch.from_numpy(Y[sl]))
            ex.run_fwd_bwd(is_train=True)
            qs = comps[r].compress_many(
                names, [ex.grad_dict[k]._handle for k in names])
            total = [q.clone() for q in qs] if total is None else \
                [t + q for t, q in zip(total, qs)]
        for k, t in zip(names, total):
            upd(k, mx.nd.NDArray(t), weights[k])
    torch.cuda.synchronize()
    out = digest({k: w.asnumpy() for k, w in weights.items()})
    del mod, weights, comps
    torch.cuda.empty_cache()
    return out


def phase_dist_module(torch, mx, kernels, kv_mod, get_symbol, here, tmp,
                      backend, card):
    """38a; returns each rank's launches summed."""
    res = dist_phase(here, 2, "38a", backend, tmp)
    per_step = -(-res[0]["keys"] // kernels.two_bit_segments_per_launch())
    steps = DIST_A["steps"]
    for r, got in enumerate(res):
        for key in FLASH_B12:
            check(got["launches"][key] == TRAIN["num_layers"] * steps,
                  "38a rank %d: %s launched %d times over %d steps"
                  % (r, key, got["launches"][key], steps))
        check(got["launches"]["two_bit_compress"] == per_step * steps,
              "38a rank %d: two_bit_compress launched %d times, want %d "
              "(one grouped call per push)"
              % (r, got["launches"]["two_bit_compress"], per_step * steps))
        check(got["backend"] == backend and got["world"] == 2,
              "38a rank %d ran on %s over %d ranks"
              % (r, got["backend"], got["world"]))
    check(res[0]["digest"] == res[1]["digest"],
          "38a: the two ranks' parameters differ after %d steps" % steps)
    want = two_bit_sum_reference(torch, mx, kv_mod, get_symbol, 2)
    bad = [k for k in want if want[k] != res[0]["digest"].get(k)]
    check(not bad, "38a: %d of %d parameters differ from the one-process "
          "sum of the two ranks' compressed gradients: %s"
          % (len(bad), len(want), bad[:4]))
    ms = [statistics.median(g["step_ms"][1:]) for g in res]
    log("38a Module.fit kvstore='dist_sync' with 2-bit compression "
        "(threshold %g) over 2 ranks on %s, backend %s: GPT-2-small "
        "L%d h%d V%d T%d f32, batch %d a rank (16 global), %d keys, %.1f M "
        "parameters, %d steps: step ms rank 0 %s, rank 1 %s (median after "
        "the first: %.1f / %.1f); all-reduce payload %.1f MB a step in %d "
        "call(s) (audit); peak memory %.2f / %.2f GB; both ranks' weights "
        "bit-equal to each other and to one process summing the two "
        "compressed gradients [%s]"
        % (DIST_A["threshold"], "one card" if torch.cuda.device_count()
           == 1 else "two cards", backend, TRAIN["num_layers"],
           TRAIN["hidden"], TRAIN["vocab_size"], TRAIN["seq_len"],
           DIST_A["batch"], res[0]["keys"], res[0]["params"] / 1e6, steps,
           ", ".join("%.1f" % x for x in res[0]["step_ms"]),
           ", ".join("%.1f" % x for x in res[1]["step_ms"]), ms[0], ms[1],
           res[0]["push_bytes"] / 1e6, res[0]["push_calls"],
           res[0]["peak_gb"], res[1]["peak_gb"], card))
    total = {}
    for g in res:
        for k, v in g["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def worker_38bc(torch, parallel, here):
    """38b and 38c in one rank of an NCCL gang: dp 2 where the machine
    has two cards, else dp 1 in a one-rank group.  38b: the plain dp and
    ZeRO trainers (``local_batch=True``, this rank's rows of each global
    batch).  38c: the Criteo recommender over the gang's dp mesh against
    one process's step over a one-device mesh on the whole batch."""
    import torch.distributed as dist
    from mxnet_tpu_torch import sparse as tsp
    from mxnet_tpu_torch.models.transformer import get_symbol
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import (MeshSpec, ShardedTrainer, audit,
                                          data_parallel_mesh, make_mesh)
    out = {"backend": parallel.backend(), "world": parallel.world_size()}
    x = torch.ones(1, device="cuda")
    audit.collective("all-reduce", "38b NCCL check",
                     lambda: dist.all_reduce(x), nbytes=4)
    torch.cuda.synchronize()
    out["nccl_check"] = float(x)
    spec = data_parallel_mesh()
    n, r = spec.dp_size, spec.dp_rank
    B, T = DIST_B["batch"], TRAIN["seq_len"]
    b = B // n
    net = get_symbol(**TRAIN)
    shapes = {"data": (b, T), "softmax_label": (b, T)}
    batches = [{k: v[r * b:(r + 1) * b] for k, v in lm_batch(
        TRAIN["vocab_size"], B, T, 380 + i).items()}
        for i in range(DIST_B["steps"])]
    kernels.reset_launches()
    runs = {}
    for tag, kw in (("dp", {}), ("zero", {"zero": True})):
        tr = ShardedTrainer(net, spec, lr=DIST_B["lr"],
                            momentum=DIST_B["momentum"], wd=0.0, **kw)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        params, mom, aux = tr.init_state(shapes, seed=0)
        torch.cuda.synchronize()
        state_bytes = torch.cuda.memory_allocated() - before
        start = [p.clone() for p in params]
        mom_bytes = sum(m.numel() * m.element_size() for m in mom)
        audit.clear_collective_log()
        times, losses = [], []
        for bt in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, mom, aux, loss = tr.step(params, mom, aux, bt,
                                             local_batch=True)
            losses.append(float(loss))
            times.append((time.perf_counter() - t0) * 1e3)
        log1 = [e for e in audit.collective_log() if e["step"] == 1]
        moved = {k: sum(e["bytes"] for e in log1 if e["kind"] == k)
                 for k in ("all-reduce", "reduce-scatter", "all-gather")}
        model = None
        if tr.shard_weight_update:
            model = audit.zero_update_model_bytes(*tr._zero_split_bytes(),
                                                  tr.dp)
        runs[tag] = (params, mom_bytes, times, losses, start, state_bytes,
                     moved, model)
        del mom, aux, tr
    pd, pz = runs["dp"][0], runs["zero"][0]
    worst = 0.0
    for a, z, s0 in zip(pd, pz, runs["dp"][4]):
        upd = float((a - s0).abs().max())
        err = float((a - z).abs().max())
        if upd:
            worst = max(worst, err / upd)
    out["b"] = {"launches": dict(kernels.LAUNCHES), "worst": worst,
                "equal": all(torch.equal(a, z) for a, z in zip(pd, pz)),
                "digest": digest({str(i): p.cpu().numpy()
                                  for i, p in enumerate(pz)}),
                "mom_bytes": [runs["dp"][1], runs["zero"][1]],
                "state_bytes": [runs["dp"][5], runs["zero"][5]],
                "moved": [runs["dp"][6], runs["zero"][6]],
                "model": runs["zero"][7],
                "ms": [runs["dp"][2], runs["zero"][2]],
                "loss": [runs["dp"][3], runs["zero"][3]], "dp": n}
    del runs, pd, pz
    torch.cuda.empty_cache()
    geo = CRITEO
    kernels.reset_launches()
    embs = [tsp.ShardedEmbedding(geo["rows"], geo["dim"], spec,
                                 name="table%d" % f)
            for f in range(geo["tables"])]
    state = tsp.recommender_state(embs, dense_dim=geo["dense"],
                                  hidden=geo["hidden"], seed=0)
    plain = MeshSpec(make_mesh((1,), ("dp",)))
    pembs = [tsp.ShardedEmbedding(geo["rows"], geo["dim"], plain,
                                  name="plain%d" % f)
             for f in range(geo["tables"])]
    ref = tsp.recommender_state(pembs, dense_dim=geo["dense"],
                                hidden=geo["hidden"], seed=0)
    step = tsp.make_recommender_step(embs, lr=geo["lr"],
                                     momentum=geo["momentum"])
    pstep = tsp.make_recommender_step(pembs, lr=geo["lr"],
                                      momentum=geo["momentum"])
    k = embs[0].rows_per_shard
    rows = slice(r * k, (r + 1) * k)
    gb = geo["batch"] // n
    launches_c, losses, plosses = {}, [], []
    touched = [torch.zeros(geo["rows"], dtype=torch.bool, device="cuda")
               for _ in range(geo["tables"])]
    for i in range(DIST_C["steps"]):
        batch = rec_batch(torch, geo, 380 + i, "cuda")
        for f, t in enumerate(touched):
            t[batch["ids"][f].long()] = True
        mine = {"ids": batch["ids"][:, r * gb:(r + 1) * gb],
                "dense": batch["dense"][r * gb:(r + 1) * gb],
                "label": batch["label"][r * gb:(r + 1) * gb]}
        before = dict(kernels.LAUNCHES)
        state, loss = step(state, mine)
        losses.append(float(loss))
        launches_c = {key: launches_c.get(key, 0) + v - before.get(key, 0)
                      for key, v in kernels.LAUNCHES.items()}
        ref, ploss = pstep(ref, batch)
        plosses.append(float(ploss))
    # duplicate ids' gradient rows sum through index_add_, whose atomics
    # add in no fixed order on the card: touched rows agree to rounding,
    # untouched rows bit for bit
    worst, untouched_equal = 0.0, True
    pairs = list(zip(state["tables"] + state["moms"],
                     ref["tables"] + ref["moms"], touched + touched))
    for a, whole, hit in pairs:
        want, hit = whole[rows], hit[:whole.shape[0]][rows]
        worst = max(worst, float((a - want).abs().max())
                    / max(float(want.abs().max()), 1e-30))
        untouched_equal &= bool(torch.equal(a[~hit], want[~hit]))
    for key in ref["mlp"]:
        a, want = state["mlp"][key], ref["mlp"][key]
        worst = max(worst, float((a - want).abs().max())
                    / max(float(want.abs().max()), 1e-30))
    out["c"] = {"launches": launches_c, "worst": worst,
                "untouched_equal": untouched_equal,
                "touched": int(touched[0].sum()), "loss": losses,
                "plain_loss": plosses, "dp": n, "rows": k}
    return out


def phase_dist_trainer_rec(torch, here, tmp, probe, card):
    """38b and 38c over two NCCL ranks where two ranks can talk NCCL (two
    cards), else the same code at dp 1 in a one-rank NCCL group, with the
    reason printed; returns their launches, summed over the ranks."""
    n = 2 if probe["collectives"].get("all_reduce") == "ok" else 1
    res = dist_phase(here, n, "38bc", "nccl", tmp)
    for g in res:
        check(g["backend"] == "nccl" and g["nccl_check"] == float(n),
              "38b: the NCCL group of %d did not run (%s)" % (n, g))
    why = ""
    if n == 1:
        why = ("dp 2 was not run: NCCL refuses two ranks of one "
               "communicator on one card (step 0: %s), and this machine "
               "has %d card(s); it waits for a machine with two cards. The "
               "same code at dp 1 over a one-rank NCCL group: "
               % (probe["collectives"].get("all_reduce", "?")[:60],
                  probe["device_count"]))
    b = [g["b"] for g in res]
    check(all(x["digest"] == b[0]["digest"] for x in b),
          "38b: the ranks' ZeRO parameters differ")
    for r, x in enumerate(b):
        check(x["equal"] or x["worst"] <= 1e-5, "38b rank %d: the ZeRO run "
              "differs from the plain dp run by %.3g of the largest update"
              % (r, x["worst"]))
        for key in FLASH_B12:
            want = 2 * TRAIN["num_layers"] * DIST_B["steps"]
            check(x["launches"][key] == want, "38b rank %d: %s launched %d "
                  "times, want %d" % (r, key, x["launches"][key], want))
        if n > 1:
            check(x["mom_bytes"][1] * n <= x["mom_bytes"][0] * 1.04,
                  "38b rank %d: ZeRO holds %d momentum bytes, the plain "
                  "run %d" % (r, x["mom_bytes"][1], x["mom_bytes"][0]))
            model, moved = x["model"], x["moved"][1]
            check(moved["reduce-scatter"] == model["reduce-scatter"] and
                  moved["all-gather"] == model["all-gather"],
                  "38b rank %d: audit %s, zero_update_model_bytes %s"
                  % (r, moved, model))
    x = b[0]
    log("38b %sShardedTrainer(local_batch=True) plain and ZeRO on "
        "GPT-2-small at global batch %d over dp %d (NCCL), lr %g, momentum "
        "%g, %d steps: step ms %s / %s, losses %s / %s, parameters %s; "
        "momentum bytes a rank %d / %d, state bytes allocated a rank "
        "(torch.cuda.memory_allocated) %d / %d; audit bytes of a step %s "
        "/ %s, zero_update_model_bytes %s [%s]"
        % (why, DIST_B["batch"], x["dp"], DIST_B["lr"], DIST_B["momentum"],
           DIST_B["steps"], ", ".join("%.1f" % t for t in x["ms"][0]),
           ", ".join("%.1f" % t for t in x["ms"][1]),
           ", ".join("%.4f" % v for v in x["loss"][0]),
           ", ".join("%.4f" % v for v in x["loss"][1]),
           "bit-equal" if all(g["equal"] for g in b) else
           "within %.3g of the largest update" % max(g["worst"] for g in b),
           x["mom_bytes"][0], x["mom_bytes"][1], x["state_bytes"][0],
           x["state_bytes"][1], x["moved"][0], x["moved"][1], x["model"],
           card))
    c = [g["c"] for g in res]
    steps = DIST_C["steps"]
    for r, x in enumerate(c):
        check(x["untouched_equal"], "38c rank %d: an untouched row differs "
              "from the one-process step's" % r)
        check(x["worst"] <= 1e-6, "38c rank %d: the recommender over the dp "
              "mesh differs from the one-process step by %.3g of a tensor's "
              "largest magnitude" % (r, x["worst"]))
        for got, want in zip(x["loss"], x["plain_loss"]):
            check(abs(got - want) <= 1e-6 * abs(want), "38c rank %d: loss "
                  "%r, the one-process step's %r" % (r, got, want))
        check(x["launches"].get("embedding_gather") == 2 * steps,
              "38c rank %d: embedding_gather launched %s times over %d "
              "steps" % (r, x["launches"].get("embedding_gather"), steps))
        check(x["launches"].get("embedding_scatter") == 2 * CRITEO["tables"]
              * steps, "38c rank %d: embedding_scatter launched %s times"
              % (r, x["launches"].get("embedding_scatter")))
    log("38c %sthe recommender at the Criteo shape (26 tables x 1,000,000 x "
        "64 f32, batch 8192) over the NCCL gang's dp mesh of %d (%d rows "
        "of each table a rank), %d steps, losses %s within 1e-6 of one "
        "process's step over a one-device mesh on the whole batch; every "
        "untouched row bit-equal, every table, momentum and MLP tensor "
        "within %.3g of its largest magnitude (tolerance 1e-6: duplicate "
        "ids' rows sum through index_add_'s atomics); %d rows of table 0 "
        "touched; B5/B6 launches a rank %s [%s]"
        % (why, c[0]["dp"], c[0]["rows"], steps,
           ", ".join("%.6f" % v for v in c[0]["loss"]),
           max(x["worst"] for x in c), c[0]["touched"],
           {k: v for k, v in c[0]["launches"].items() if v}, card))

    def total(part):
        out = {}
        for g in res:
            for key, v in g[part]["launches"].items():
                out[key] = out.get(key, 0) + v
        return out
    return total("b"), total("c")


def phase_dist_contexts(torch, mx, kernels, card):
    """38d: ResNet-50 through a Module over two contexts (MXNet's
    ``context=[gpu(0), gpu(1)]``; on one card ``gpu(0)`` twice, as the JAX
    package accepts a repeated context: one executor each) at batch 32
    split 16/16 with
    ``KVStore("device")``, held to the rule the CPU lane tests: the store
    sums the two executors' gradients and updates once."""
    from mxnet_tpu_torch.models import resnet
    D = DIST_D
    B = D["batch"]
    net = resnet.get_symbol(**RESNET50)
    shapes = conv_net_shapes(RESNET50, B, "NCHW")
    half = {k: (B // 2,) + tuple(v[1:]) for k, v in shapes.items()}
    rs = np.random.RandomState(384)
    X = rs.randn(D["steps"], *shapes["data"]).astype(np.float32)
    Y = rs.randint(0, 1000, (D["steps"], B)).astype(np.float32)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ctxs = [mx.gpu(0), mx.gpu(min(1, torch.cuda.device_count() - 1))]
        mod = mx.mod.Module(net, context=ctxs)
        mod.bind([("data", shapes["data"])], [("softmax_label", (B,))])
        mx.random.seed(0)
        mod.init_params(initializer=mx.init.Xavier(magnitude=2))
        args, auxs = mod.get_params()
        args = {k: v.copy() for k, v in args.items()}
        mod.init_optimizer(kvstore=mx.kv.create("device"), optimizer="sgd",
                           optimizer_params={"learning_rate": D["lr"],
                                             "momentum": D["momentum"]})
        kernels.reset_launches()
        times = []
        for i in range(D["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(mx.io.DataBatch([mx.nd.array(
                X[i], ctx=mx.cpu())], [mx.nd.array(Y[i], ctx=mx.cpu())]))
            mod.update()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        got, _ = mod.get_params()
        got = {k: v.asnumpy() for k, v in got.items()}
        slices = [s.stop - s.start for s in mod._exec_group.slices]
        del mod
        ref = mx.mod.Module(net, context=mx.gpu(0))
        ref.bind([("data", half["data"])], [("softmax_label", (B // 2,))])
        ref.init_params(initializer=None, arg_params=args, aux_params=auxs)
        ex = ref._exec_group.execs[0]
        names = ref._exec_group.param_names
        opt = mx.optimizer.create("sgd", sym=net,
                                  param_idx2name=dict(enumerate(names)),
                                  learning_rate=D["lr"],
                                  momentum=D["momentum"],
                                  rescale_grad=1.0 / B)
        upd = mx.optimizer.get_updater(opt)
        weights = {k: mx.nd.NDArray(ex.arg_dict[k]._handle.clone())
                   for k in names}
        for i in range(D["steps"]):
            grads = []
            for h in range(2):
                sl = slice(h * B // 2, (h + 1) * B // 2)
                for k in names:
                    ex.arg_dict[k]._handle.copy_(weights[k]._handle)
                ex.arg_dict["data"]._handle.copy_(torch.from_numpy(X[i][sl]))
                ex.arg_dict["softmax_label"]._handle.copy_(
                    torch.from_numpy(Y[i][sl]))
                ex.run_fwd_bwd(is_train=True)
                grads.append([ex.grad_dict[k]._handle.clone()
                              for k in names])
            for k, g0, g1 in zip(names, *grads):
                upd(k, mx.nd.NDArray(g0 + g1), weights[k])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    worst, unequal = 0.0, 0
    for k in names:
        a, b = got[k], weights[k].asnumpy()
        upd_mag = float(np.abs(b - args[k].asnumpy()).max())
        err = float(np.abs(a - b).max())
        unequal += int(err > 0)
        if upd_mag:
            worst = max(worst, err / upd_mag)
    check(worst <= 1e-5, "38d: the two-context Module's weights differ "
          "from the summed-gradient reference by %.3g of the largest "
          "update" % worst)
    log("38d Module(context=%s) over ResNet-50 at batch %d "
        "split %s with KVStore('device'), cudnn deterministic, %d steps: "
        "step ms %s; weights %s the one-context reference that sums the "
        "two halves' gradients (%d of %d tensors not bit-equal, worst "
        "%.3g of the largest update) [%s]"
        % (ctxs, B, "/".join(map(str, slices)), D["steps"],
           ", ".join("%.1f" % t for t in times),
           "bit-equal to" if not unequal else "within 1e-5 of", unequal,
           len(names), worst, card))
    del ref, weights
    torch.cuda.empty_cache()
    return dict(kernels.LAUNCHES)


def phase_dist(torch, mx, kernels, kv_mod, get_symbol, here, card):
    """Phase 38; returns the launches of its paths and step 0's probes
    (phase 39 reads them too)."""
    import tempfile
    torch.cuda.empty_cache()
    probes = {b: dist_probe(here, b) for b in ("nccl", "gloo")}
    log("38 step 0 (tools/torch_dist_probe.py, two ranks, CUDA tensors): "
        "%d card(s), NCCL %s: nccl %s; gloo %s [%s]"
        % (probes["nccl"]["device_count"], probes["nccl"]["nccl"],
           json.dumps(probes["nccl"]["collectives"]),
           json.dumps(probes["gloo"]["collectives"]), card))
    two_ranks_nccl = probes["nccl"]["collectives"].get("all_reduce") == "ok"
    backend = "nccl" if two_ranks_nccl else "gloo"
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        launches["a"] = phase_dist_module(torch, mx, kernels, kv_mod,
                                          get_symbol, here, tmp, backend,
                                          card)
        launches["b"], launches["c"] = phase_dist_trainer_rec(
            torch, here, tmp, probes["nccl"], card)
    launches["d"] = phase_dist_contexts(torch, mx, kernels, card)
    return launches, probes


# -- phase 39: tensor parallelism ----------------------------------------------
#
# 39a: the tp ShardedTrainer on GPT-2-small (TRAIN, f32, TF32 off): tp 2
# over two ranks of one card on gloo (NCCL refuses two ranks of one card),
# dp2 x tp2 over NCCL where the machine has four cards; its update against
# one process's on the same data.  39b: tp-2 decode of FULL through the
# DecodeEngine on rank 0 (rank 1 follows), f32, int8 and int4, against the
# one-process program; B3 and B4 at the per-rank shapes against their
# plain versions.  39c: Module.fit of example/model_parallel/two_stage.py's
# net over group2ctxs, bit-equal to the unsegmented Module.
TP_A = dict(batch=2, steps=3, lr=1e-4, momentum=0.9, seed=39)
TP_B = dict(requests=4, max_new=16, seed=391, forced=3, cached=512)
TP_C = dict(batch=16, rows=64, dim=16, hidden=64, epochs=3, lr=0.5)
TP_TIMEOUT = 600


def tp_train_rank(torch, parallel):
    """39a on one rank: three tp steps from the seeded state; rank 0 then
    runs the same steps in one process and holds the update to it."""
    from mxnet_tpu_torch.models.transformer import get_symbol
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import MeshSpec, ShardedTrainer, audit
    A, n = TP_A, parallel.world_size()
    axes = {"dp": n // 2, "tp": 2} if n > 2 else {"tp": 2}
    spec = MeshSpec.build(axes)
    B, T = A["batch"] * spec.dp_size, TRAIN["seq_len"]
    net = get_symbol(**TRAIN)
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    hyper = dict(lr=A["lr"], momentum=A["momentum"], wd=0.0)
    tr = ShardedTrainer(net, spec, **hyper)
    params, mom, aux = tr.init_state(shapes, seed=A["seed"])
    rs = np.random.RandomState(A["seed"])
    batches = [{k: rs.randint(0, TRAIN["vocab_size"], (B, T)).astype(
        np.float32) for k in shapes} for _ in range(A["steps"])]
    kernels.reset_launches()
    audit.clear_collective_log()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        params, mom, aux, loss = tr.step(params, mom, aux, b)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = audit.bytes_by_axis(step=1)
            calls = len([e for e in audit.collective_log()
                         if e["step"] == 1])
    launches = dict(kernels.LAUNCHES)
    whole = tr.get_params(params)
    out = {"launches": launches, "step_ms": times, "loss": losses,
           "audit": first, "collectives": calls, "axes": axes,
           "digest": digest({k: v.cpu().numpy()
                             for k, v in zip(tr.param_names, whole)}),
           "block_bytes": sum(p.numel() * p.element_size() for p in params),
           "mom_bytes": sum(m.numel() * m.element_size() for m in mom),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if parallel.rank() != 0:
        return out
    one = ShardedTrainer(net, **hyper)
    p1, m1, a1 = one.init_state(shapes, seed=A["seed"])
    start = [p.clone() for p in p1]
    ref_losses = []
    for b in batches:
        p1, m1, a1, loss = one.step(p1, m1, a1, b)
        ref_losses.append(float(loss))
    upds = [(pr - p0).abs().max().item() for p0, pr in zip(start, p1)]
    errs = [(pt - pr).abs().max().item() for pr, pt in zip(p1, whole)]
    # a tensor whose gradient vanishes (the key bias: softmax ignores a
    # shift common to every key) moves by rounding alone: each update is
    # measured against at least 1e-4 of the largest one
    floor = 1e-4 * max(upds)
    ratios = [e / max(u, floor) for u, e in zip(upds, errs)]
    i = int(np.argmax(ratios))
    out.update(ref_loss=ref_losses, worst=ratios[i],
               worst_name=one.param_names[i], exact=sum(e == 0 for e in errs),
               tensors=len(start))
    return out


def tp_decode_rank(torch, parallel):
    """39b on one rank of a tp-2 gang: per precision, teacher-forced steps
    with every rank calling ``step`` (one step's audit trail; rank 0 holds
    tokens and logits to the one-process program), then the engine on
    rank 0 with rank 1 following (rank 0 holds the tokens to the
    one-process engine's), then the steady step's ms."""
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import audit
    from mxnet_tpu_torch.serving.decode import (
        DecodeConfig, DecodeEngine, DecodeProgram, decode_tp_model_bytes,
        follow_engine, init_decode_params)
    c = FULL
    cfg = DecodeConfig(c["vocab_size"], c["num_layers"], c["hidden"],
                       c["heads"], c["seq_len"], page_size=c["page_size"],
                       max_seqs=c["max_seqs"])
    params = init_decode_params(cfg, seed=0)
    rs = np.random.RandomState(TP_B["seed"])
    requests = [(rs.randint(0, cfg.vocab_size, int(rs.randint(16, 65))),
                 TP_B["max_new"]) for _ in range(TP_B["requests"])]
    leader = parallel.rank() == 0
    out = {"model": decode_tp_model_bytes(cfg, 2)}
    for qz in (None, "int8", "int4"):
        tag = qz or "f32"
        prog = DecodeProgram(params, cfg, mesh={"tp": 2}, quantize=qz,
                             name="tp-" + tag)
        prog.ensure_compiled()
        audit.clear_collective_log()
        forced, _ = teacher_forced([prog], TP_B["forced"], 7, 5)
        last = audit.collective_log()[-(2 * cfg.num_layers + int(
            prog.head_split)):]
        res = {"audit": audit.bytes_by_axis(last)}
        kernels.reset_launches()
        if leader:
            with DecodeEngine(prog, default_deadline=300.0) as eng:
                futs = [eng.submit(p, max_new_tokens=m) for p, m in requests]
                toks = [f.result(timeout=300)[0].tolist() for f in futs]
                st = eng.stats()
            res["steps"] = st["counters"]["steps"]
            res["token_step_ms"] = st["decode"]["token_step_s"]["p50"] * 1e3
        else:
            res["steps"] = follow_engine([prog])["steps"]
        res["launches"] = dict(kernels.LAUNCHES)
        res["host_ms"], res["b2b_ms"] = step_timing(torch, prog,
                                                    TP_B["cached"], steps=10)
        if leader:
            one = DecodeProgram(params, cfg, quantize=qz, name="one-" + tag)
            ref, _ = teacher_forced([one], TP_B["forced"], 7, 5)
            res["logit_err"] = max((a[1] - b[1]).abs().max().item()
                                   for a, b in zip(forced[0], ref[0]))
            res["forced_equal"] = all(torch.equal(a[0], b[0]) for a, b in
                                      zip(forced[0], ref[0]))
            with DecodeEngine(one, default_deadline=300.0) as eng:
                futs = [eng.submit(p, max_new_tokens=m) for p, m in requests]
                res["engine_equal"] = toks == [
                    f.result(timeout=300)[0].tolist() for f in futs]
            del one
        out[tag] = res
        del prog
        torch.cuda.empty_cache()
    return out


def phase_tp_train(torch, res, backend, card):
    """39a's checks and report; returns the launches summed over the
    ranks."""
    r0 = res[0]
    steps, L = TP_A["steps"], TRAIN["num_layers"]
    for r, g in enumerate(res):
        for key in FLASH_B12:
            check(g["launches"].get(key) == L * steps,
                  "39a rank %d: %s launched %s times over %d steps"
                  % (r, key, g["launches"].get(key), steps))
        want = {a for a, k in r0["axes"].items() if k > 1}
        check(set(g["audit"]) == want, "39a rank %d: collectives on %s, "
              "want %s" % (r, sorted(g["audit"]), sorted(want)))
        check(g["digest"] == r0["digest"], "39a: rank %d's parameters "
              "differ from rank 0's after %d steps" % (r, steps))
    # the update, not the weights: next to a weight's own magnitude a
    # wrong gradient would hide in the rounding.  The tp step
    # sums the same products in other orders (partial input gradients
    # added over tp): 1e-3 of the largest update of each tensor
    check(r0["worst"] <= 1e-3, "39a: the tp update of %s differs from the "
          "one-process update by %.3g of its largest"
          % (r0["worst_name"], r0["worst"]))
    check(np.allclose(r0["loss"], r0["ref_loss"], rtol=1e-5),
          "39a: losses %s against one process's %s"
          % (r0["loss"], r0["ref_loss"]))
    tp = r0["audit"].get("tp", {})
    log("39a tp ShardedTrainer over %s on %s, backend %s: GPT-2-small "
        "L%d h%d V%d T%d f32, global batch %d, %d steps: step ms rank 0 "
        "%s, rank 1 %s; %d collectives a step, tp payload a step %s MB, "
        "dp %s; per rank parameter blocks %.1f MB, momentum %.1f MB, peak "
        "%.2f GB; losses %s (one process %s); update within %.3g of the "
        "one-process update's largest (worst %s; %d of %d tensors "
        "bit-equal); the "
        "ranks' whole parameters bit-equal; B1/B2 %d launches a rank [%s]"
        % (r0["axes"], "one card" if torch.cuda.device_count() == 1 else
           "%d cards" % torch.cuda.device_count(), backend,
           TRAIN["num_layers"], TRAIN["hidden"], TRAIN["vocab_size"],
           TRAIN["seq_len"], TP_A["batch"] * r0["axes"].get("dp", 1),
           steps, ", ".join("%.1f" % x for x in r0["step_ms"]),
           ", ".join("%.1f" % x for x in res[1]["step_ms"]),
           r0["collectives"], json.dumps({k: round(v / 1e6, 3)
                                          for k, v in tp.items()}),
           json.dumps({k: round(v / 1e6, 3) for k, v in
                       r0["audit"].get("dp", {}).items()}),
           r0["block_bytes"] / 1e6, r0["mom_bytes"] / 1e6, r0["peak_gb"],
           ["%.4f" % x for x in r0["loss"]],
           ["%.4f" % x for x in r0["ref_loss"]], r0["worst"],
           r0["worst_name"], r0["exact"], r0["tensors"], L * steps, card))
    total = {}
    for g in res:
        for k, v in g["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_tp_decode(torch, res, card):
    """39b's checks and report; returns the launches summed over the
    ranks."""
    L = FULL["num_layers"]
    total = {}
    for tag in ("f32", "int8", "int4"):
        r0 = res[0][tag]
        for r, g in enumerate(res):
            got = g[tag]
            check(got["audit"] == {"tp": res[0]["model"]},
                  "39b %s rank %d: one step's collectives %s, the model "
                  "says %s on tp" % (tag, r, got["audit"], res[0]["model"]))
            check(got["steps"] == r0["steps"], "39b %s: rank %d ran %d "
                  "steps, rank 0 %d" % (tag, r, got["steps"], r0["steps"]))
            check(got["launches"].get("decode_attention") ==
                  L * got["steps"], "39b %s rank %d: decode_attention "
                  "launched %s times over %d steps"
                  % (tag, r, got["launches"].get("decode_attention"),
                     got["steps"]))
            if tag != "f32":
                want = (6 * L + 1) * got["steps"]
                check(got["launches"].get("quant_matmul_" + tag) == want,
                      "39b %s rank %d: quant_matmul launched %s times, "
                      "want %d" % (tag, r, got["launches"].get(
                          "quant_matmul_" + tag), want))
            for k, v in got["launches"].items():
                total[k] = total.get(k, 0) + v
        check(r0["forced_equal"] and r0["engine_equal"], "39b %s: the tp-2 "
              "tokens differ from the one-process program's" % tag)
        if tag == "f32":
            check(r0["logit_err"] <= 1e-4, "39b f32: logits differ from "
                  "the one-process step's by %.3g" % r0["logit_err"])
        log("39b tp-2 decode %s of %s: engine %d steps, token step p50 "
            "%.3f ms (rank 0's engine); steady step at %d cached a slot "
            "%.3f ms waiting for tokens, %.3f ms back to back (rank 0), "
            "%.3f / %.3f (rank 1); tokens equal to one process, "
            "teacher-forced logits within %.3g; one step's collectives %s "
            "= decode_tp_model_bytes(cfg, 2), all on tp [%s]"
            % (tag, "L%d H%d heads%d V%d" % (L, FULL["hidden"], FULL["heads"],
                                             FULL["vocab_size"]),
               r0["steps"], r0["token_step_ms"], TP_B["cached"],
               r0["host_ms"], r0["b2b_ms"], res[1][tag]["host_ms"],
               res[1][tag]["b2b_ms"], r0["logit_err"], r0["audit"]["tp"],
               card))
    return total


def tp_kernel_rows(torch, kernels, timer, card):
    """B3 and B4 at the shapes a tp-2 rank gives them (half the heads; the
    per-rank blocks of every matmul) against their plain versions."""
    c, tp = FULL, 2
    h, V, L = c["hidden"], c["vocab_size"], c["num_layers"]
    import torch.nn.functional as F
    rows = decode_attention_rows(torch, kernels, F, timer, c["heads"] // tp,
                                 L, "tp-2 rank, ")
    shapes = [("q/k/v", h // tp, h, 3 * L), ("proj", h, h // tp, L),
              ("ff1", 4 * h // tp, h, L), ("ff2", h, 4 * h // tp, L),
              ("head", V // tp, h, 1)]
    rows += quant_matmul_rows(torch, kernels, timer, shapes, "tp-2 rank, ")
    log_rows(rows, card)
    return rows


def phase_tp_contexts(torch, mx, kernels, card):
    """39c: Module.fit of example/model_parallel/two_stage.py's net over
    group2ctxs (stage1 on gpu(0), stage2 on gpu(1) where there are two
    cards, else gpu(0)), against the unsegmented Module on gpu(0) from the
    same weights and batches: bit-equal."""
    C = TP_C
    second = mx.gpu(min(1, torch.cuda.device_count() - 1))
    g2c = {"stage1": mx.gpu(0), "stage2": second}

    def net():
        data = mx.sym.Variable("data")
        with mx.AttrScope(ctx_group="stage1"):
            x = mx.sym.FullyConnected(data, num_hidden=C["hidden"],
                                      name="fc1")
            x = mx.sym.Activation(x, act_type="relu")
        with mx.AttrScope(ctx_group="stage2"):
            x = mx.sym.FullyConnected(x, num_hidden=2, name="fc2")
            return mx.sym.SoftmaxOutput(x, name="softmax")

    rs = np.random.RandomState(0)
    X = rs.normal(0, 1, (C["rows"], C["dim"])).astype(np.float32)
    Y = (X.sum(1) > 0).astype(np.float32)
    start = {"fc1_weight": rs.normal(0, .3, (C["hidden"], C["dim"])),
             "fc1_bias": np.zeros(C["hidden"]),
             "fc2_weight": rs.normal(0, .3, (2, C["hidden"])),
             "fc2_bias": np.zeros(2)}
    out, times = {}, {}
    # each fit twice, in turns; the second pass is kept (the first warms
    # the card's libraries)
    for tag, groups in (("plain", None), ("segmented", g2c)) * 2:
        mod = mx.mod.Module(net(), context=mx.gpu(0), group2ctxs=groups)
        it = mx.io.NDArrayIter(X, Y, batch_size=C["batch"],
                               label_name="softmax_label")
        kernels.reset_launches()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=C["epochs"], initializer=None,
                arg_params={k: mx.nd.array(v.astype(np.float32),
                                           ctx=mx.cpu())
                            for k, v in start.items()},
                optimizer_params={"learning_rate": C["lr"]})
        torch.cuda.synchronize()
        times[tag] = (time.perf_counter() - t0) * 1e3
        if groups:
            devs = mod._exec_group.execs[0].ctx_group_devices
            check(devs is not None and len(devs) == (
                2 if second != mx.gpu(0) else 1),
                  "39c: segments on %s" % (devs,))
        metric = mx.metric.Accuracy()
        mod.score(it, metric)
        out[tag] = ({k: v.asnumpy() for k, v in mod.get_params()[0]
                     .items()}, metric.get()[1], devs if groups else None)
    bad = [k for k in out["plain"][0]
           if not np.array_equal(out["plain"][0][k], out["segmented"][0][k])]
    check(not bad, "39c: the segmented Module's weights differ from the "
          "unsegmented Module's: %s" % bad)
    log("39c Module.fit over group2ctxs %s (segments on %s), %d epochs of "
        "%d rows at batch %d: %.1f ms (unsegmented %.1f ms; each the "
        "second of two fits in turns), accuracy "
        "%.3f, every weight bit-equal to the unsegmented Module's on "
        "gpu(0) [%s]" % (g2c, out["segmented"][2], C["epochs"], C["rows"],
                         C["batch"], times["segmented"], times["plain"],
                         out["segmented"][1], card))
    return dict(kernels.LAUNCHES)


def phase_tp(torch, mx, kernels, here, probes, card):
    """Phase 39; returns its kernel rows and the launches of its paths."""
    import tempfile
    gloo = probes["gloo"]["collectives"]
    log("39 step 0 (tools/torch_dist_probe.py): gloo new_group %s, "
        "batch_isend_irecv %s; nccl new_group %s, batch_isend_irecv %s "
        "(recorded for ring, pipeline and MoE) [%s]"
        % (gloo.get("new_group"), gloo.get("batch_isend_irecv"),
           probes["nccl"]["collectives"].get("new_group"),
           probes["nccl"]["collectives"].get("batch_isend_irecv"), card))
    nccl = probes["nccl"]["collectives"].get("all_reduce") == "ok"
    backend = "nccl" if nccl else "gloo"
    check(nccl or gloo.get("new_group") == "ok", "39: gloo refuses "
          "new_group subgroups on CUDA tensors: %s" % gloo.get("new_group"))
    n = 4 if nccl and torch.cuda.device_count() >= 4 else 2
    launches = {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        if n == 2:
            res = dist_phase(here, 2, "39", backend, tmp, TP_TIMEOUT)
            a, b = [x["a"] for x in res], [x["b"] for x in res]
        else:
            a = [x["a"] for x in dist_phase(here, n, "39a", backend, tmp,
                                            TP_TIMEOUT)]
            b = [x["b"] for x in dist_phase(here, 2, "39b", backend, tmp,
                                            TP_TIMEOUT)]
    launches["a"] = phase_tp_train(torch, a, backend, card)
    launches["b"] = phase_tp_decode(torch, b, card)
    timer = Timer(torch)
    rows = tp_kernel_rows(torch, kernels, timer, card)
    del timer
    torch.cuda.empty_cache()
    launches["c"] = phase_tp_contexts(torch, mx, kernels, card)
    return rows, launches


# -- phase 40: ring attention, the GPipe schedule, MoE, the two-tier sum ------
#
# 40a: the pre-norm block of example/long_context/ring_transformer.py at
# TRAIN's widths (hidden 768, 12 heads of 64) on B 1, T 16384, causal,
# its attention ring-parallel over sp (8192 a rank at sp 2), f32 then
# bf16, against one process running the block with the flash kernels
# over the whole sequence.  40b: TRAIN's 12 blocks as S stages (6 a
# stage at S 2) through PipelineRunner.loss_and_grad, 4 micro-batches of
# (2, 1024, 768) f32, against the 12 blocks in sequence.  40c:
# Switch-Base-8's FFN (d_model 768, d_ff 3072, 8 experts, top-1, ReLU;
# Fedus et al. 2021) over ep, 16 x 512 tokens f32, against moe_ffn_dense,
# then 5 SGD steps at capacity factor 1.25.  40d: the two-tier all-reduce
# of the LM's gradient set over island 2 x dp 2 (4 ranks) against the flat
# all-reduce.  On one card the gangs run on gloo (NCCL refuses two ranks
# of one card), each hop one all_to_all_single with split sizes (the
# probe says gloo takes it); on four cards NCCL at n = 4.

RING_A = dict(B=1, T=16384, seed=40, steps=3, hops=5)
PIPE_B = dict(micro=4, mb=2, seed=41, steps=2)
MOE_C = dict(d=768, ff=3072, experts=8, cf=1.25, tokens=16 * 512,
             gate_std=0.05, std=0.02, shift=0.3, aux=0.01, lr=5.0, steps=5,
             seed=42)
HIER_D = dict(islands=2, dp=2, seed=43)
STEP2_TIMEOUT = 600


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rel_err(a, b):
    """max|a - b| over max|b|, in float32."""
    a, b = a.detach().float(), b.detach().float()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def norm_gap(a, b, scale):
    """||a - b|| over ||scale||, in float32."""
    return ((a.detach().float() - b.detach().float()).norm()
            / scale.detach().float().norm().clamp_min(1e-30)).item()


def ring_block(torch, p, x, attn, heads):
    """example/long_context/ring_transformer.py's pre-norm block: x +
    attn(q, k, v) wo, then x + gelu(x w1) w2."""
    import torch.nn.functional as F
    B, T, D = x.shape
    xn = (x - x.mean(-1, keepdim=True)) / (
        x.std(-1, keepdim=True, correction=0) + 1e-5)
    q, k, v = ((xn @ p[w]).view(B, T, heads, D // heads)
               for w in ("wq", "wk", "wv"))
    x = x + attn(q, k, v).reshape(B, T, D) @ p["wo"]
    return x + F.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]


def ring_params(hidden, seed):
    rs = np.random.RandomState(seed)
    shapes = {"wq": (hidden, hidden), "wk": (hidden, hidden),
              "wv": (hidden, hidden), "wo": (hidden, hidden),
              "w1": (hidden, 4 * hidden), "w2": (4 * hidden, hidden)}
    return {k: rs.normal(0, 0.02, s).astype(np.float32)
            for k, s in shapes.items()}


def causal_attention_f64(torch, q, k, v, chunk=512):
    """Causal softmax attention over (B, T, H, D) in float64, ``chunk``
    queries at a time against the keys up to the chunk's end, each chunk
    recomputed in the backward (one (T, T) float64 score set at T 16384
    would take 26 GB)."""
    import math
    from torch.utils.checkpoint import checkpoint
    T, D = q.shape[1], q.shape[3]

    def rows(qc, k, v, s):
        end = s + qc.shape[1]
        sc = torch.einsum("bqhd,bkhd->bhqk", qc, k[:, :end]) / math.sqrt(D)
        qi = torch.arange(s, end, device=q.device)[:, None]
        ki = torch.arange(end, device=q.device)[None]
        sc = sc.masked_fill(ki > qi, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), v[:, :end])

    return torch.cat([checkpoint(rows, q[:, s:s + chunk], k, v, s,
                                 use_reentrant=False)
                      for s in range(0, T, chunk)], 1)


def ring_witness(torch, host, x_host, heads, dev):
    """40a's block over the whole sequence in float64 (the witness the f32
    ring and the f32 one-process run are each measured against): the
    output, dx and every parameter's gradient."""
    B, T, D = x_host.shape
    pw = {k: torch.from_numpy(v).to(dev, torch.float64).requires_grad_()
          for k, v in host.items()}
    xw = torch.from_numpy(x_host).to(dev, torch.float64).requires_grad_()
    y = ring_block(torch, pw, xw, lambda q, k, v: causal_attention_f64(
        torch, q, k, v), heads)
    ((y ** 2).sum() / (B * T * D)).backward()
    out = {"out": y.detach(), "dx": xw.grad}
    out.update({"d" + k: p.grad for k, p in pw.items()})
    return out


def rel_err64(a, b):
    """max|a - b| over max|b|, ``b`` float64."""
    return (a.detach().double() - b).abs().max().item() / max(
        b.abs().max().item(), 1e-300)


def ring_rank(torch, parallel, n, cfg=None, widths=None, dev=None):
    """40a on one rank: the block's forward and backward with its
    attention ring-parallel over sp, f32 then bf16 (the main path: one
    step with the launches counted, then ``steps`` timed), the hop alone
    timed; against the block over the whole sequence with
    ``kernels.flash_attention`` in this process (this rank's out and dx
    shards, every parameter's whole gradient)."""
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import MeshSpec, audit, comm
    A = dict(RING_A, **(cfg or {}))
    W = dict(TRAIN, **(widths or {}))
    spec = MeshSpec.build({"sp": n}, device=dev)
    dev = spec.device
    r = spec.mesh.axis_index("sp")
    B, T, D, H = A["B"], A["T"], W["hidden"], W["heads"]
    Tl = T // n
    host = ring_params(D, A["seed"])
    x_host = np.random.RandomState(A["seed"] + 1).normal(
        0, 1, (B, T, D)).astype(np.float32)
    out = {"rank": r, "n": n, "T": T, "hop_bytes": {}}
    refs = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        params = {k: torch.from_numpy(v).to(dev, dt).requires_grad_()
                  for k, v in host.items()}
        xl = torch.from_numpy(x_host[:, r * Tl:(r + 1) * Tl].copy()).to(
            dev, dt).requires_grad_()

        def attn(q, k, v):
            return parallel.ring_attention(q, k, v, spec, axis="sp",
                                           causal=True)

        def step():
            for t in list(params.values()) + [xl]:
                t.grad = None
            pr = {k: comm.replicated_input(p, "sp", spec)
                  for k, p in params.items()}
            y = ring_block(torch, pr, xl, attn, H)
            loss = (y.float() ** 2).sum() / (B * T * D)
            loss.backward()
            return y.detach(), loss.detach()

        kernels.reset_launches()
        audit.clear_collective_log()
        _sync(torch, dev)
        y, loss = step()
        _sync(torch, dev)
        res = {"launches": dict(kernels.LAUNCHES),
               "audit": audit.bytes_by_axis(),
               "collectives": len(audit.collective_log())}
        times = []
        for _ in range(A["steps"]):
            _sync(torch, dev)
            t0 = time.perf_counter()
            step()
            _sync(torch, dev)
            times.append((time.perf_counter() - t0) * 1e3)
        # the hop alone: k and v of one block, stacked, to the neighbour
        kv = torch.zeros((2, B, Tl, H, D // H), dtype=dt, device=dev)
        group = spec.mesh.group("sp")
        hop_ms = []
        for _ in range(A["hops"]):
            _sync(torch, dev)
            t0 = time.perf_counter()
            comm.ppermute_start(kv, comm.ring_perm(n), group, "sp",
                                "phase 40a hop").wait()
            _sync(torch, dev)
            hop_ms.append((time.perf_counter() - t0) * 1e3)
        out["hop_bytes"][dtype] = kv.numel() * kv.element_size()
        # the whole sequence in this process
        pw = {k: torch.from_numpy(v).to(dev, dt).requires_grad_()
              for k, v in host.items()}
        xw = torch.from_numpy(x_host).to(dev, dt).requires_grad_()
        yw = ring_block(torch, pw, xw, lambda q, k, v: kernels.flash_attention(
            q, k, v, causal=True), H)
        lw = (yw.float() ** 2).sum() / (B * T * D)
        lw.backward()
        mine = slice(r * Tl, (r + 1) * Tl)
        got = {"out": y, "dx": xl.grad}
        got.update({"d" + k: p.grad for k, p in params.items()})
        want = {"out": yw.detach()[:, mine], "dx": xw.grad[:, mine]}
        want.update({"d" + k: p.grad for k, p in pw.items()})
        res["err"] = {k: rel_err(got[k], want[k]) for k in got}
        if dtype == "float32":
            refs = {k: v.float().clone() for k, v in want.items()}
            del pw, xw, yw, want
            # which of the two f32 results is nearer the exact value
            w64 = ring_witness(torch, host, x_host, H, dev)
            w64["out"], w64["dx"] = w64["out"][:, mine], w64["dx"][:, mine]
            res["err64"] = {k: rel_err64(got[k], w64[k]) for k in got}
            res["proc_err64"] = {k: rel_err64(refs[k], w64[k]) for k in got}
            del w64
        else:
            # each tensor's distance from the one-process bf16 run against
            # that run's own distance from the f32 run, norm-wise
            res["gap"] = {k: norm_gap(got[k], want[k], refs[k]) for k in got}
            res["own_gap"] = {k: norm_gap(want[k], refs[k], refs[k])
                              for k in got}
        res.update(step_ms=times, hop_ms=hop_ms, loss=loss.item(),
                   loss_whole=lw.item())
        out[dtype] = res
        del params, y, xl
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def lm_layer(torch, hidden, layer, seed, dev):
    """One GPT-2 block's parameters, from a seed per layer."""
    g = torch.Generator().manual_seed(seed * 1000 + layer)
    D = hidden

    def normal(*shape, std=0.02):
        return (torch.randn(shape, generator=g) * std).to(dev)

    return {"ln1_g": 1 + normal(D), "ln1_b": normal(D),
            "wqkv": normal(D, 3 * D), "bqkv": normal(3 * D),
            "wo": normal(D, D), "bo": normal(D),
            "ln2_g": 1 + normal(D), "ln2_b": normal(D),
            "w1": normal(D, 4 * D), "b1": normal(4 * D),
            "w2": normal(4 * D, D), "b2": normal(D)}


def lm_block(torch, kernels, p, x, heads):
    """GPT-2's pre-LN block, its attention causal on the flash kernels."""
    import torch.nn.functional as F
    B, T, D = x.shape
    h = F.layer_norm(x, (D,), p["ln1_g"], p["ln1_b"])
    q, k, v = (h @ p["wqkv"] + p["bqkv"]).view(B, T, 3, heads,
                                               D // heads).unbind(2)
    a = kernels.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
    x = x + a.reshape(B, T, D) @ p["wo"] + p["bo"]
    h = F.layer_norm(x, (D,), p["ln2_g"], p["ln2_b"])
    return x + F.gelu(h @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] \
        + p["b2"]


def pipe_rank(torch, parallel, n, cfg=None, widths=None, dev=None):
    """40b on one rank: TRAIN's blocks as n stages through
    ``PipelineRunner.loss_and_grad`` (the main path: one call with the
    launches counted, then ``steps`` timed); against the blocks in
    sequence over each micro-batch in this process (the loss, and this
    stage's gradients)."""
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import MeshSpec, PipelineRunner, audit
    C = dict(PIPE_B, **(cfg or {}))
    W = dict(TRAIN, **(widths or {}))
    spec = MeshSpec.build({"pp": n}, device=dev)
    dev = spec.device
    s = spec.mesh.axis_index("pp")
    L, D, H, T = W["num_layers"], W["hidden"], W["heads"], W["seq_len"]
    per = L // n
    layers = [lm_layer(torch, D, i, C["seed"], dev) for i in range(L)]
    mine = {k: torch.stack([layers[s * per + i][k] for i in range(per)])
            for k in layers[0]}

    def stage_fn(p, x):
        for i in range(per):
            x = lm_block(torch, kernels, {k: v[i] for k, v in p.items()}, x,
                         H)
        return x

    g = torch.Generator().manual_seed(C["seed"])
    M, mb = C["micro"], C["mb"]
    x = torch.randn((M, mb, T, D), generator=g).to(dev)
    y = torch.randn((M, mb, T, D), generator=g).to(dev)

    def mse(pred, tgt):
        return torch.mean((pred - tgt) ** 2)

    runner = PipelineRunner(stage_fn, n, spec, axis="pp")
    kernels.reset_launches()
    audit.clear_collective_log()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(torch, dev)
    t0 = time.perf_counter()
    loss, grads = runner.loss_and_grad(mse, mine, x, y)
    _sync(torch, dev)
    first = (time.perf_counter() - t0) * 1e3
    out = {"stage": s, "n": n, "launches": dict(kernels.LAUNCHES),
           "first_ms": first, "ticks": M + 2 * (n - 1), "per_stage": per}
    trail = audit.collective_log()
    out["audit_fwd"] = audit.bytes_by_axis(
        [e for e in trail if not e["tag"].endswith("backward")])
    out["audit_bwd"] = audit.bytes_by_axis(
        [e for e in trail if e["tag"].endswith("backward")])
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None
    times = []
    for _ in range(C["steps"]):
        _sync(torch, dev)
        t0 = time.perf_counter()
        runner.loss_and_grad(mse, mine, x, y)
        _sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    # the blocks in sequence, micro-batch by micro-batch
    leaves = [{k: v.clone().requires_grad_() for k, v in lay.items()}
              for lay in layers]
    preds = []
    for m in range(M):
        h = x[m]
        for lay in leaves:
            h = lm_block(torch, kernels, lay, h, H)
        preds.append(h)
    ref = mse(torch.stack(preds), y)
    ref.backward()
    errs = {}
    for k in mine:
        for i in range(per):
            errs["l%d_%s" % (s * per + i, k)] = rel_err(
                grads[k][i], leaves[s * per + i][k].grad)
    worst = max(errs, key=errs.get)
    out.update(loss=loss.item(), ref_loss=ref.item(), step_ms=times,
               worst=errs[worst], worst_name=worst, tensors=len(errs),
               exact=sum(e == 0 for e in errs.values()))
    return out


def moe_weights(torch, C, dev):
    g = torch.Generator().manual_seed(C["seed"])
    d, ff, E, N = C["d"], C["ff"], C["experts"], C["tokens"]
    # tokens that share a mean direction (as a trained model's hidden
    # states do) load the experts unevenly: some overflow at 1.25
    x = torch.randn((N, d), generator=g) + C["shift"] * torch.randn(
        (d,), generator=g)
    wg = torch.randn((d, E), generator=g) * C["gate_std"]
    w1 = torch.randn((E, d, ff), generator=g) * C["std"]
    w2 = torch.randn((E, ff, d), generator=g) * C["std"]
    tgt = torch.randn((N, d), generator=g) * 0.1
    return [t.to(dev) for t in (x, wg, w1, w2, tgt)]


def moe_rank(torch, parallel, n, cfg=None, dev=None):
    """40c on one rank: at capacity factor 8 (no drops) out and every
    gradient against ``moe_ffn_dense`` over all tokens in this process; at
    1.25 the dropped rows 0 and the others equal, one call's audit trail;
    then ``steps`` SGD steps of the regression at 1.25 (each rank's loss
    its tokens' part plus the replicated aux term)."""
    import math
    from mxnet_tpu_torch.parallel import MeshSpec, audit, moe
    C = dict(MOE_C, **(cfg or {}))
    spec = MeshSpec.build({"ep": n}, device=dev)
    dev = spec.device
    r = spec.mesh.axis_index("ep")
    x, wg, w1, w2, tgt = moe_weights(torch, C, dev)
    N, E, d = C["tokens"], C["experts"], C["d"]
    tl, el = N // n, E // n
    rows, exp = slice(r * tl, (r + 1) * tl), slice(r * el, (r + 1) * el)
    out = {"rank": r, "n": n}

    def leaves(*ts):
        return [t.detach().clone().requires_grad_() for t in ts]

    # capacity factor 8: nothing dropped, so the dense result
    xs, g1, a1, b1 = leaves(x[rows], wg, w1[exp], w2[exp])
    o, _aux = parallel.moe_ffn(xs, g1, a1, b1, spec, capacity_factor=8.0)
    (o ** 2).sum().div(N).backward()
    xd, gd, ad, bd = leaves(x, wg, w1, w2)
    od, _ = moe.moe_ffn_dense(xd, gd, ad, bd)
    (od ** 2).sum().div(N).backward()
    out["err_cf8"] = {
        "out": rel_err(o, od[rows]), "dx": rel_err(xs.grad, xd.grad[rows]),
        "dwg": rel_err(g1.grad, gd.grad), "dw1": rel_err(a1.grad,
                                                          ad.grad[exp]),
        "dw2": rel_err(b1.grad, bd.grad[exp])}
    # capacity factor 1.25: dropped rows are 0, the rest the dense rows
    audit.clear_collective_log()
    with torch.no_grad():
        o = parallel.moe_ffn(x[rows], wg, w1[exp], w2[exp], spec,
                             capacity_factor=C["cf"])[0]
    out["audit"] = audit.bytes_by_axis()
    out["calls"] = [e["kind"] for e in audit.collective_log()]
    out["capacity"] = int(math.ceil(tl * C["cf"] / E))
    dropped = (o == 0).all(dim=1)
    out["dropped"] = int(dropped.sum())
    # the tokens the routing must drop, in plain code: each token's argmax
    # expert, its 1-based place among this shard's tokens of that expert,
    # dropped past the capacity
    with torch.no_grad():
        chosen = torch.softmax(x[rows] @ wg, dim=-1).argmax(dim=-1).tolist()
    seen, want = [0] * E, []
    for e in chosen:
        seen[e] += 1
        want.append(seen[e] > out["capacity"])
    want = torch.tensor(want, device=dev)
    out["want_dropped"] = int(want.sum())
    out["dropped_as_routed"] = bool(torch.equal(dropped, want))
    out["err_kept"] = rel_err(o[~dropped], od.detach()[rows][~dropped])
    # training at 1.25
    xs = x[rows]
    g1, a1, b1 = leaves(wg, w1[exp], w2[exp])
    losses, parts, times = [], [], []
    for i in range(C["steps"] + 1):
        _sync(torch, dev)
        t0 = time.perf_counter()
        for t in (g1, a1, b1):
            t.grad = None
        o, aux = parallel.moe_ffn(xs, g1, a1, b1, spec,
                                  capacity_factor=C["cf"])
        part = ((o - tgt[rows]) ** 2).sum() / (N * d)
        (part + C["aux"] * aux).backward()
        if i < C["steps"]:
            with torch.no_grad():
                for t in (g1, a1, b1):
                    t -= C["lr"] * t.grad
        _sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
        parts.append(part.item())
        losses.append(aux.item())
    out.update(parts=parts, aux=losses, step_ms=times[1:-1],
               wg_digest=digest({"wg": g1.detach().cpu().numpy()}),
               a2a_bytes=2 * E * out["capacity"] * d * 4)
    return out


def lm_grad_shapes(get_symbol):
    """The shapes of the LM's (TRAIN) parameters, in argument order."""
    net = get_symbol(**TRAIN)
    shapes = {"data": (1, TRAIN["seq_len"]),
              "softmax_label": (1, TRAIN["seq_len"])}
    args, _, _ = net.infer_shape(**shapes)
    return [tuple(s) for a, s in zip(net.list_arguments(), args)
            if a not in shapes]


def hier_rank(torch, parallel, shapes=None, dev=None):
    """40d on one rank of island 2 x dp 2: the two-tier all-reduce of a
    gradient set (the LM's) against the flat all-reduce, on integer-valued
    data (bit-equal) and on normal data (within rounding), each call's
    audit trail against ``hierarchical_allreduce_model_bytes``."""
    from mxnet_tpu_torch.models.transformer import get_symbol
    from mxnet_tpu_torch.parallel import MeshSpec, audit
    C = HIER_D
    spec = MeshSpec.build({"island": C["islands"], "dp": C["dp"]},
                          device=dev)
    dev = spec.device
    r = parallel.rank()
    shapes = shapes or lm_grad_shapes(get_symbol)
    gen = torch.Generator(device=dev).manual_seed(C["seed"] + r)
    normal = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    ints = [torch.randint(-1000, 1000, s, generator=gen, device=dev).float()
            for s in shapes]
    model = {}
    for s in shapes:
        m = audit.hierarchical_allreduce_model_bytes(
            4 * int(np.prod(s)), C["islands"], C["dp"])
        for kind, axis in (("reduce-scatter", "dp"), ("all-reduce", "island"),
                           ("all-gather", "dp")):
            model.setdefault(axis, {})
            model[axis][kind] = model[axis].get(kind, 0) + m[kind]
    out = {"rank": r, "tensors": len(shapes),
           "bytes": 4 * sum(int(np.prod(s)) for s in shapes), "model": model}
    times = {}
    for tag, vals in (("ints", ints), ("normal", normal)):
        audit.clear_collective_log()
        _sync(torch, dev)
        t0 = time.perf_counter()
        hier = parallel.hierarchical_grad_allreduce(vals, spec)
        _sync(torch, dev)
        times["hier_" + tag] = (time.perf_counter() - t0) * 1e3
        out["audit_" + tag] = audit.bytes_by_axis()
        t0 = time.perf_counter()
        flat = [parallel.flat_allreduce(v, spec) for v in vals]
        _sync(torch, dev)
        times["flat_" + tag] = (time.perf_counter() - t0) * 1e3
        if tag == "ints":
            out["ints_equal"] = all(torch.equal(a, b)
                                    for a, b in zip(hier, flat))
        else:
            # each order of a 4-term sum is within 3u of sum|v|: the two
            # within 6u
            u = 2.0 ** -24
            worst = 0.0
            for a, b, v in zip(hier, flat, vals):
                bound = 6 * u * parallel.flat_allreduce(v.abs(), spec)
                worst = max(worst, ((a - b).abs() / bound.clamp_min(
                    1e-30)).max().item())
            out["normal_ratio"] = worst
            out["normal_equal"] = sum(torch.equal(a, b)
                                      for a, b in zip(hier, flat))
        del hier, flat
    out["ms"] = times
    return out


def step2_worker(torch, parallel, which):
    """``chip_smoke.py --dist-worker 40|40d OUTDIR`` on one rank."""
    n = parallel.world_size()
    if which == "40d":
        return {"d": hier_rank(torch, parallel)}
    res = {"a": ring_rank(torch, parallel, n)}
    torch.cuda.empty_cache()
    res["b"] = pipe_rank(torch, parallel, n)
    torch.cuda.empty_cache()
    res["c"] = moe_rank(torch, parallel, n)
    return res


def ring_launch_want(r, n):
    """B1 / B2a / B2b launches a causal ring step gives rank r of n: the
    diagonal block and the r blocks below it."""
    return r + 1


def phase_ring(torch, res, backend, card):
    """40a's checks and report; returns the launches summed over the
    ranks, by dtype."""
    n, T = res[0]["n"], res[0]["T"]
    total = {}
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        for g in res:
            got, r = g[dtype], g["rank"]
            for key in FLASH_B12:
                want = ring_launch_want(r, n)
                check(got["launches"].get(key + sfx) == want,
                      "40a %s rank %d: %s launched %s times in one step, "
                      "want %d" % (dtype, r, key + sfx,
                                   got["launches"].get(key + sfx), want))
            check(set(got["audit"]) == {"sp"}, "40a %s rank %d: collectives "
                  "on %s" % (dtype, r, sorted(got["audit"])))
            # the forward's n-1 k/v hops, the backward's n-1 k/v and n
            # dk/dv hops, and one all-reduce per parameter gradient
            check(got["collectives"] == 3 * n - 2 + 6, "40a %s rank %d: %d "
                  "collectives in a step" % (dtype, r, got["collectives"]))
            if dtype == "float32":
                # the output within 1e-4 of its largest; each gradient, a
                # sum over 16384 tokens split at the rank's block, within
                # 1e-3 of its largest (39a's bar for sums in another order)
                bad = {k: v for k, v in got["err"].items()
                       if v > (1e-4 if k == "out" else 1e-3)}
                check(not bad, "40a f32 rank %d: against one process %s "
                      "(all: %s)" % (r, bad, got["err"]))
                # against the float64 witness: within 1e-4 of the largest
                # (the bar against one process before the witness), or no
                # farther than twice the one-process f32 run
                far = {k: (v, got["proc_err64"][k]) for k, v in
                       got["err64"].items()
                       if v > max(1e-4, 2 * got["proc_err64"][k])}
                check(not far, "40a f32 rank %d: from the float64 witness "
                      "(ring, one process) %s" % (r, far))
            else:
                bad = {k: (v, got["own_gap"][k]) for k, v in
                       got["gap"].items() if v > 3 * got["own_gap"][k]}
                check(not bad, "40a bf16 rank %d: norm-wise gaps (ring, "
                      "own bf16-vs-f32) %s" % (r, bad))
            for k, v in got["launches"].items():
                total[k] = total.get(k, 0) + v
        r0 = res[0][dtype]
        lw = [g[dtype]["loss"] for g in res]
        log("40a ring attention over sp %d on %s, backend %s, hop as one "
            "all_to_all_single with split sizes: the ring_transformer block "
            "at hidden %d, %d heads, B %d, T %d (%d a rank), causal, %s: "
            "step ms (forward + backward + 6 gradient all-reduces) rank 0 %s, "
            "rank %d %s; hop %.1f MB (k and v of one block), %s ms alone "
            "(rank 0); launches a step B1/B2a/B2b %s by rank; against one "
            "process over the whole sequence: %s; loss parts %s sum %.6f, "
            "one process %.6f [%s]"
            % (n, "one card" if torch.cuda.device_count() == 1 else
               "%d cards" % torch.cuda.device_count(), backend,
               TRAIN["hidden"], TRAIN["heads"], RING_A["B"], T, T // n,
               dtype, ", ".join("%.1f" % t for t in r0["step_ms"]), n - 1,
               ", ".join("%.1f" % t for t in res[-1][dtype]["step_ms"]),
               res[0]["hop_bytes"][dtype] / 1e6,
               ", ".join("%.2f" % t for t in r0["hop_ms"]),
               [ring_launch_want(g["rank"], n) for g in res],
               ("max err over max|ref| (bars: out 1e-4, gradients 1e-3) "
                + json.dumps({k: float("%.3g" % max(g[dtype]["err"][k]
                                                     for g in res))
                              for k in r0["err"]})
                + "; from a float64 witness over the whole sequence, ring / "
                "one process (bar: 1e-4 or twice the one process) "
                + json.dumps({k: "%.3g / %.3g" % (
                    max(g[dtype]["err64"][k] for g in res),
                    max(g[dtype]["proc_err64"][k] for g in res))
                    for k in r0["err64"]})) if dtype == "float32"
               else
               ("norm-wise gap / own bf16-vs-f32 gap " + json.dumps(
                   {k: "%.3g / %.3g" % (max(g[dtype]["gap"][k] for g in res),
                                        r0["own_gap"][k])
                    for k in r0["gap"]})),
               ["%.6f" % v for v in lw], sum(lw), r0["loss_whole"], card))
    return total


def phase_pipe(torch, res, backend, card):
    """40b's checks and report; returns the launches summed over the
    ranks."""
    n = res[0]["n"]
    total = {}
    for g in res:
        s, ticks, per = g["stage"], g["ticks"], g["per_stage"]
        for key in FLASH_B12:
            check(g["launches"].get(key) == per * ticks,
                  "40b stage %d: %s launched %s times, want %d layers x %d "
                  "ticks" % (s, key, g["launches"].get(key), per, ticks))
        check(set(g["audit_fwd"]) == {"pp"} and set(g["audit_bwd"]) <= {"pp"},
              "40b stage %d: collectives on %s / %s"
              % (s, sorted(g["audit_fwd"]), sorted(g["audit_bwd"])))
        mb = PIPE_B["mb"] * TRAIN["seq_len"] * TRAIN["hidden"] * 4
        want = {"collective-permute": mb * ticks,
                "all-reduce": mb * PIPE_B["micro"]}
        check(g["audit_fwd"]["pp"] == want, "40b stage %d: forward trail %s, "
              "pipeline.py:120-121 counts %s" % (s, g["audit_fwd"]["pp"],
                                                 want))
        check(g["worst"] <= 1e-3, "40b stage %d: gradient %s differs from "
              "the blocks in sequence by %.3g of its largest"
              % (s, g["worst_name"], g["worst"]))
        check(abs(g["loss"] - g["ref_loss"]) <= 1e-5 * abs(g["ref_loss"]),
              "40b stage %d: loss %.7f, in sequence %.7f"
              % (s, g["loss"], g["ref_loss"]))
        for k, v in g["launches"].items():
            total[k] = total.get(k, 0) + v
    r0 = res[0]
    log("40b GPipe over pp %d on %s, backend %s: TRAIN's %d blocks as %d "
        "stages of %d, %d micro-batches of (%d, %d, %d) f32, %d ticks, "
        "through PipelineRunner.loss_and_grad: first call %.1f ms, then %s "
        "ms (rank 0); peak %s GB a rank; forward hops %.1f MB and output "
        "all-reduce %.1f MB a rank (pipeline.py:120-121's count), backward "
        "hops %.1f MB; loss %.7f (in sequence %.7f); worst gradient within "
        "%.3g of its largest (%s; %s of %d tensors a stage bit-equal); "
        "B1/B2a/B2b %d launches a stage [%s]"
        % (n, "one card" if torch.cuda.device_count() == 1 else
           "%d cards" % torch.cuda.device_count(), backend,
           TRAIN["num_layers"], n, r0["per_stage"], PIPE_B["micro"],
           PIPE_B["mb"], TRAIN["seq_len"], TRAIN["hidden"], r0["ticks"],
           r0["first_ms"], ", ".join("%.1f" % t for t in r0["step_ms"]),
           ", ".join("%.2f" % g["peak_gb"] for g in res),
           r0["audit_fwd"]["pp"]["collective-permute"] / 1e6,
           r0["audit_fwd"]["pp"]["all-reduce"] / 1e6,
           r0["audit_bwd"].get("pp", {}).get("collective-permute", 0) / 1e6,
           r0["loss"], r0["ref_loss"], max(g["worst"] for g in res),
           max(res, key=lambda g: g["worst"])["worst_name"],
           [g["exact"] for g in res], r0["tensors"],
           r0["per_stage"] * r0["ticks"], card))
    return total


def phase_moe(torch, res, backend, card):
    """40c's checks and report."""
    C = MOE_C
    n = res[0]["n"]
    for g in res:
        r = g["rank"]
        bad = {k: v for k, v in g["err_cf8"].items()
               if v > (1e-4 if k == "out" else 1e-3)}
        check(not bad, "40c rank %d: at capacity factor 8, against "
              "moe_ffn_dense %s (all: %s)" % (r, bad, g["err_cf8"]))
        check(g["err_kept"] <= 1e-4, "40c rank %d: kept rows at %.2f differ "
              "from dense by %.3g" % (r, C["cf"], g["err_kept"]))
        check(g["dropped_as_routed"], "40c rank %d: at %.2f the zero rows "
              "(%d) are not the tokens past their expert's capacity in "
              "plain routing (%d)" % (r, C["cf"], g["dropped"],
                                      g["want_dropped"]))
        check(g["calls"] == ["all-to-all", "all-to-all", "all-reduce"] and
              g["audit"] == {"ep": {"all-to-all": g["a2a_bytes"],
                                    "all-reduce": 4}},
              "40c rank %d: one call's trail %s %s, moe.py:141 says "
              "2 all-to-all of %d bytes in all and a 4-byte all-reduce"
              % (r, g["calls"], g["audit"], g["a2a_bytes"]))
        check(g["wg_digest"] == res[0]["wg_digest"], "40c: the replicated "
              "gate differs between ranks after %d steps" % C["steps"])
    losses = [sum(g["parts"][i] for g in res) + C["aux"] * res[0]["aux"][i]
              for i in range(C["steps"] + 1)]
    check(losses[-1] < losses[0], "40c: the loss did not fall: %s" % losses)
    r0 = res[0]
    log("40c Switch-Base-8 FFN over ep %d on %s, backend %s: d_model %d, "
        "d_ff %d, %d experts (%d a rank), top-1, ReLU, %d tokens (%d a "
        "rank), f32: at capacity factor 8 out, dx, dwg, dw1, dw2 within %s "
        "of moe_ffn_dense's largest (bars: out 1e-4, gradients 1e-3); at "
        "%.2f (capacity %d) %s tokens dropped by rank, rows 0, exactly "
        "those past their expert's capacity in plain routing (%s), the rest "
        "within %.3g; one call: 2 "
        "all-to-all, %.2f MB in all, and a 4-byte all-reduce (moe.py:141); "
        "%d SGD steps (lr %g): loss %s; step ms %s (rank 0) [%s]"
        % (n, "one card" if torch.cuda.device_count() == 1 else
           "%d cards" % torch.cuda.device_count(), backend, C["d"], C["ff"],
           C["experts"], C["experts"] // n, C["tokens"], C["tokens"] // n,
           json.dumps({k: float("%.3g" % max(g["err_cf8"][k] for g in res))
                       for k in r0["err_cf8"]}), C["cf"], r0["capacity"],
           [g["dropped"] for g in res], [g["want_dropped"] for g in res],
           max(g["err_kept"] for g in res),
           r0["a2a_bytes"] / 1e6, C["steps"], C["lr"],
           ["%.6f" % v for v in losses],
           ", ".join("%.1f" % t for t in r0["step_ms"]), card))


def phase_hier(torch, res, backend, card):
    """40d's checks and report."""
    for g in res:
        r = g["rank"]
        for tag in ("ints", "normal"):
            check(g["audit_" + tag] == g["model"], "40d rank %d %s: trail "
                  "%s, hierarchical_allreduce_model_bytes %s"
                  % (r, tag, g["audit_" + tag], g["model"]))
        check(g["ints_equal"], "40d rank %d: the two-tier sum of "
              "integer-valued data differs from the flat all-reduce" % r)
        check(g["normal_ratio"] <= 1.0, "40d rank %d: the two-tier sum is "
              "%.3g of 6u sum|v| from the flat one" % (r, g["normal_ratio"]))
    r0 = res[0]
    log("40d two-tier all-reduce over island %d x dp %d (4 ranks on %s, "
        "backend %s) of the LM's %d gradients (%.1f MB f32 a rank): "
        "integer-valued data bit-equal to flat_allreduce; normal data "
        "within %.3g of the 6u sum|v| bound (%d of %d tensors bit-equal); "
        "each rank's trail by axis = hierarchical_allreduce_model_bytes "
        "%s; ms (rank 0; the ints pass runs first and meets each group's "
        "first collective) %s [%s]"
        % (HIER_D["islands"], HIER_D["dp"], "one card" if
           torch.cuda.device_count() == 1 else "%d cards" %
           torch.cuda.device_count(), backend, r0["tensors"],
           r0["bytes"] / 1e6, max(g["normal_ratio"] for g in res),
           r0["normal_equal"], r0["tensors"], json.dumps(r0["model"]),
           json.dumps({k: round(v, 1) for k, v in r0["ms"].items()}), card))


def ring_kernel_rows(torch, kernels, F, n, card):
    """B1 / B2a / B2b as a ring rank runs them, f32 and bf16, on a
    two-block problem at 40a's block (T / n a rank): the diagonal block
    causal, the one below it unmasked, dQ and dK/dV against the merged lse
    and delta.  Each is held against its plain version on the same inputs,
    then timed with the plain versions and SDPA beside them."""
    from mxnet_tpu_torch.parallel import ring
    dev = torch.device("cuda")
    H, D = TRAIN["heads"], TRAIN["hidden"] // TRAIN["heads"]
    B, T = RING_A["B"], RING_A["T"] // n
    rows = []

    def problem(dt):
        """q of block 1, k/v of blocks 0 and 1, dO; the merged out, lse and
        delta from the kernels' forward, as the ring makes them."""
        g = torch.Generator(device=dev).manual_seed(T)
        q, k0, v0, k1, v1, do = (torch.randn((B, T, H, D), generator=g,
                                             device=dev).to(dt)
                                 for _ in range(6))
        o, lse = ring._merge(None, None,
                             *kernels.flash_attention_fwd(q, k0, v0, False))
        o, lse = ring._merge(o, lse,
                             *kernels.flash_attention_fwd(q, k1, v1, True))
        o = o.to(dt)
        return q, (k0, v0, False), (k1, v1, True), do, o, lse, \
            kernels.flash_delta(o, do)

    def compare(dtype, q, k, v, do, lse, delta, causal):
        """Each kernel's max_abs_err against its plain version and the
        error over its tolerance (those of phases 6 and 20)."""
        out, ls = kernels.flash_attention_fwd(q, k, v, causal)
        ref, ref_ls = kernels.flash_attention_fwd_plain(q, k, v, causal)
        dq = kernels.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = kernels.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 causal)
        rq = kernels.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                  causal)
        rk, rv = kernels.flash_attention_bwd_dkv_plain(q, k, v, do, lse,
                                                       delta, causal)
        torch.cuda.synchronize()
        pairs = (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))
        if dtype == "float32":
            e = {"out": (out - ref).abs().max().item(),
                 "lse": (ls - ref_ls).abs().max().item()}
            t = {"out": 1e-5, "lse": 1e-5}
            for nm, a, b in pairs:
                e[nm] = (a - b).abs().max().item()
                t[nm] = 1e-4 * max(1.0, b.abs().max().item())
            return e, {x: e[x] / t[x] for x in e}
        ratio = {"out": lowp_close(torch, out, ref, 1e-5)}
        lse_e = (ls - ref_ls).abs().max().item()
        ratio["lse"] = (lse_e / (1e-5 * max(1.0, ref_ls.abs().max().item())),
                        lse_e)
        for nm, a, b in pairs:
            ratio[nm] = lowp_close(torch, a, b, 1e-4)
        return ({x: r_[1] for x, r_ in ratio.items()},
                {x: r_[0] for x, r_ in ratio.items()})

    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        dt = getattr(torch, dtype)
        q, below, diag, do, o, lse, delta = problem(dt)
        errs = {}
        for mask, (k, v, causal) in (("below", below), ("diagonal", diag)):
            e, ratio = compare(dtype, q, k, v, do, lse, delta, causal)
            log("40 ring kernels %s %s block at T %d a block: max_abs_err %s, "
                "error/tolerance %s (tolerances as phases 6 and 20; dQ, dK/dV "
                "read the two blocks' merged lse and delta)"
                % (dtype, mask, T,
                   ", ".join("%s %.3g" % kv for kv in e.items()),
                   ", ".join("%s %.3g" % kv for kv in ratio.items())))
            check(all(x <= 1.0 for x in ratio.values()), "40: the ring's %s "
                  "%s block disagrees with the plain versions" % (dtype, mask))
            errs[mask] = e
        torch.cuda.empty_cache()
        timer, slow = Timer(torch), Timer(torch, iters=5)
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        dot = do.transpose(1, 2).contiguous()
        for mask, (k, v, causal) in (("below", below), ("diagonal", diag)):
            kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (k, v))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal)
            lib_fwd = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            lib_bwd = timer(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dot, retain_graph=True))
            del lib_out
            shape = ("ring block (sp %d) q/k/v (%d, %d, %d, %d) %s, %s" % (
                n, B, T, H, D, dtype, "diagonal, causal" if causal else
                "below the diagonal, no mask"))
            e = errs[mask]
            specs = [
                ("flash_attention_fwd", ":250", 4, 3, 1, 1, "fwd",
                 lambda: kernels.flash_attention_fwd(q, k, v, causal),
                 lambda: kernels.flash_attention_fwd_plain(q, k, v, causal),
                 max(e["out"], e["lse"]), lib_fwd, ", with lse"),
                ("flash_attention_bwd_dq", ":448", 6, 4, 1, 2, "dq",
                 lambda: kernels.flash_attention_bwd_dq(
                     q, k, v, do, lse, delta, causal),
                 lambda: kernels.flash_attention_bwd_dq_plain(
                     q, k, v, do, lse, delta, causal),
                 e["dq"], lib_bwd, ", dO, merged lse and delta"),
                ("flash_attention_bwd_dkv", ":468", 8, 4, 2, 2, "dkv",
                 lambda: kernels.flash_attention_bwd_dkv(
                     q, k, v, do, lse, delta, causal),
                 lambda: kernels.flash_attention_bwd_dkv_plain(
                     q, k, v, do, lse, delta, causal),
                 max(e["dk"], e["dv"]), lib_bwd,
                 ", dO, merged lse and delta")]
            for (name, site, units, n_in, n_out, n_rows, kind, fn, plain,
                 err, lib, extra) in specs:
                if dtype == "float32":
                    b, by, tc = flash_bound(B, T, T, H, D, causal, units,
                                            n_in, n_out, n_rows)
                    math_ = "3xtf32 mma.sync"
                else:
                    b, by, tc = b9_bound(B, T, T, H, D, causal, units, n_in,
                                         n_out, n_rows, B9_MMAS[kind])
                    math_ = B9_MATH[kind]
                rows.append({
                    "name": name + sfx, "route": "cuda",
                    "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "mxnet_tpu/ops/pallas_kernels.py" + site,
                    "shape": shape + extra, "launches_per_step":
                    n if causal else n * (n - 1) // 2,
                    "max_abs_err": err, "ms": timer(fn),
                    "plain_ms": slow(plain), "bound_ms": b, "bound_by": by,
                    "bound_tc_ms": tc, "math": math_, "library_ms": lib,
                    "library_call": "F.scaled_dot_product_attention(%s) %s "
                    "%s" % ("is_causal=True" if causal else "no mask", dtype,
                            "forward" if kind == "fwd" else
                            "autograd backward (dQ, dK, dV together)")})
            del kt, vt
        del q, qt, below, diag, do, o, lse, delta, timer, slow
        torch.cuda.empty_cache()
    log_rows(rows, card)
    return rows


def phase_step2(torch, mx, kernels, here, probes, card):
    """Phase 40; returns its kernel rows and the launches of its paths."""
    import tempfile
    import torch.nn.functional as F
    probes = dict(probes, gloo4=dist_probe(here, "gloo", n=4))
    split = {b: probes[b]["collectives"].get("all_to_all_split_subgroup")
             for b in ("nccl", "gloo", "gloo4")}
    log("40 step 0 (tools/torch_dist_probe.py, CUDA tensors): "
        "all_to_all_single with uneven split sizes over new_group "
        "subgroups: nccl %s; gloo 2 ranks %s; gloo 4 ranks on %d card(s) "
        "%s (every collective: %s) [%s]"
        % (split["nccl"], split["gloo"], probes["gloo4"]["device_count"],
           split["gloo4"], json.dumps(probes["gloo4"]["collectives"]), card))
    nccl = probes["nccl"]["collectives"].get("all_reduce") == "ok"
    backend = "nccl" if nccl else "gloo"
    four = "nccl" if nccl else "gloo4"
    check(split[backend] == "ok" and split[four] == "ok", "40: %s refuses "
          "the split-size all_to_all_single the hop is built on: %s"
          % (backend, split))
    n = 4 if nccl and torch.cuda.device_count() >= 4 else 2
    log("40: gangs of %d (40a-40c) and 4 (40d) on %s; the hop: one "
        "all_to_all_single with split sizes (the probe's) [%s]"
        % (n, backend, card))
    torch.cuda.empty_cache()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        res = dist_phase(here, n, "40", backend, tmp, STEP2_TIMEOUT)
        launches["ring"] = phase_ring(torch, [x["a"] for x in res], backend,
                                      card)
        launches["pipe"] = phase_pipe(torch, [x["b"] for x in res], backend,
                                      card)
        phase_moe(torch, [x["c"] for x in res], backend, card)
        res = dist_phase(here, 4, "40d", backend, tmp, STEP2_TIMEOUT)
        phase_hier(torch, [x["d"] for x in res], backend, card)
    rows = ring_kernel_rows(torch, kernels, F, n, card)
    return rows, launches


def dist_worker(worker, outdir):
    """``chip_smoke.py --dist-worker WORKER OUTDIR``: one rank of a phase
    38 gang (started by tools/launch.py); writes its result to
    ``OUTDIR/WORKER.r<rank>.json``."""
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from mxnet_tpu_torch import parallel
    # a gang of one too (38b/38c on a machine with one card)
    parallel.init_distributed(num_processes=int(os.environ[
        "DMLC_NUM_WORKER"]))
    torch.cuda.set_device(parallel.gang_device())
    fn = {"38a": worker_38a, "38bc": worker_38bc,
          "39": lambda *a: {"a": tp_train_rank(torch, parallel),
                            "b": tp_decode_rank(torch, parallel)},
          "39a": lambda *a: {"a": tp_train_rank(torch, parallel)},
          "39b": lambda *a: {"b": tp_decode_rank(torch, parallel)},
          "40": lambda *a: step2_worker(torch, parallel, "40"),
          "40d": lambda *a: step2_worker(torch, parallel, "40d")}[worker]
    res = fn(torch, parallel, here)
    r = parallel.rank()
    with open(os.path.join(outdir, "%s.r%d.json" % (worker, r)), "w") as f:
        json.dump(res, f)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--dist-worker":
        return dist_worker(sys.argv[2], sys.argv[3])
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card and never falls back to the CPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch", "csrc")) \
            or not os.path.isfile(os.path.join(here, "tests",
                                               "torch_cases.py")):
        fail("mxnet_tpu_torch/ and tests/ are not beside chip_smoke.py; run "
             "it from a checkout of the repository")
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "tests"))
    import torch_cases as tc
    import torch.nn.functional as F
    from mxnet_tpu_torch.analysis.costmodel import (
        decode_step_model, transformer_flops_per_step)
    from mxnet_tpu_torch.models.transformer import (get_decode_step,
                                                    get_symbol)
    from mxnet_tpu_torch.ops import build, kernels
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.parallel.trainer import sgd_step_fn
    from mxnet_tpu_torch.serving.decode import (DecodeConfig, DecodeEngine,
                                                DecodeProgram,
                                                init_decode_params)
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch import sparse as tsp
    from mxnet_tpu_torch.parallel import MeshSpec, make_mesh
    from mxnet_tpu_torch.sparse import kernels as sk
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore as tkv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()

    with phase("1 build and identify"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        check(smi.returncode == 0, "nvidia-smi failed: %s" % smi.stderr)
        card = smi.stdout.strip().splitlines()[0].strip()
        log("card: %s | torch %s, CUDA %s, %d device(s)"
            % (card, torch.__version__, torch.version.cuda,
               torch.cuda.device_count()))
        t0 = time.perf_counter()
        paths = build.build_kernels()
        log("built %d kernel libraries in %.2f s: %s"
            % (len(paths), time.perf_counter() - t0,
               ", ".join(os.path.relpath(p, here) for p in paths.values())))
        for name in paths:
            for line in build.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    log("  ptxas %s: %s" % (name, line.strip()))
        sass_check(build, card)
        log("  ptxas nms: each image on a cluster of 1-16 CTAs of 1024 "
            "threads; a thread's flags are bits of 32- or 64-bit registers "
            "(at most 64 a thread: 524,288 boxes per image over 8 CTAs), "
            "its f64 boxes in the CTA's dynamic shared memory (7 a thread "
            "at most, f32 14) beside the inbox of a step's candidates, the "
            "rest read from global memory; layouts at SSD's (32, 30120) "
            "f64: %s; at MultiProposal's (2, 6000) f64: %s"
            % (nms_plan(32, 30120, 8), nms_plan(2, 6000, 8)))

    with phase("2 decode kernels vs plain"):
        timer = Timer(torch)
        rows = phase_kernels(torch, kernels, F, timer, card)
        host_costs(torch, kernels, card)

    with phase("3 decode step card vs cpu"):
        phase_step_parity(torch, DecodeConfig, DecodeProgram,
                          init_decode_params)

    cfg = DecodeConfig(FULL["vocab_size"], FULL["num_layers"],
                       FULL["hidden"], FULL["heads"], FULL["seq_len"],
                       page_size=FULL["page_size"],
                       max_seqs=FULL["max_seqs"])
    launches, timing, busy = {}, {}, {}
    cached = 512
    with phase("4 serve f32"):
        t0 = time.perf_counter()
        params = init_decode_params(cfg, seed=0)
        log("init_decode_params(%s, seed=0): %.1f s"
            % (cfg.describe(), time.perf_counter() - t0))
        rs = np.random.RandomState(0)
        requests = [(rs.randint(0, cfg.vocab_size, int(rs.randint(16, 513))),
                     int(rs.randint(16, 65))) for _ in range(15)]
        vip = (rs.randint(0, cfg.vocab_size, 32), 16)
        kernels.reset_launches()
        prog = get_decode_step(params, vocab_size=cfg.vocab_size,
                               seq_len=cfg.max_seq_len,
                               num_layers=cfg.num_layers, hidden=cfg.hidden,
                               heads=cfg.heads, page_size=cfg.page_size,
                               max_seqs=cfg.max_seqs, name="smoke-f32")
        res = serve(torch, kernels, DecodeEngine, prog, requests, vip=vip,
                    parity=3, card=card)
        got = dict(kernels.LAUNCHES)
        calls = res["step_calls"] + 1                 # + the warm-up step
        log("launches on the f32 path: %s over %d step calls"
            % (got, calls))
        check(got["decode_attention"] == cfg.num_layers * calls,
              "decode_attention launched %d times, want %d"
              % (got["decode_attention"], cfg.num_layers * calls))
        launches["f32"] = got
        timing["f32"] = step_timing(torch, prog, cached)
        busy["f32"] = report_profile(torch, prog, "f32", cached, card)
        del prog

    with phase("5 serve int8 and int4"):
        small = [(rs.randint(0, cfg.vocab_size, int(rs.randint(16, 65))), 16)
                 for _ in range(4)]
        for qz in ("int8", "int4"):
            kernels.reset_launches()
            prog = get_decode_step(params, vocab_size=cfg.vocab_size,
                                   seq_len=cfg.max_seq_len,
                                   num_layers=cfg.num_layers,
                                   hidden=cfg.hidden, heads=cfg.heads,
                                   page_size=cfg.page_size,
                                   max_seqs=cfg.max_seqs, quantize=qz,
                                   name="smoke-" + qz)
            res = serve(torch, kernels, DecodeEngine, prog, small, parity=1,
                        card=card)
            got = dict(kernels.LAUNCHES)
            calls = res["step_calls"] + 1
            log("launches on the %s path: %s over %d step calls"
                % (qz, got, calls))
            check(got["decode_attention"] == cfg.num_layers * calls,
                  "%s: decode_attention launches %d, want %d"
                  % (qz, got["decode_attention"], cfg.num_layers * calls))
            want = (6 * cfg.num_layers + 1) * calls
            check(got["quant_matmul_" + qz] == want,
                  "%s: quant_matmul launches %d, want %d"
                  % (qz, got["quant_matmul_" + qz], want))
            launches[qz] = got
            timing[qz] = step_timing(torch, prog, cached)
            busy[qz] = report_profile(torch, prog, qz, cached, card)
            del prog
        del params

        for qz, bits in (("f32", 32), ("int8", 8), ("int4", 4)):
            m = decode_step_model(cfg.num_layers, cfg.hidden,
                                  cfg.vocab_size, cfg.max_seqs,
                                  cfg.max_seqs * cached, bits)
            roof_ms = m["hbm_bytes"] / HBM_BYTES_S * 1e3
            host_ms, b2b_ms = timing[qz]
            dev_ms = busy[qz]
            log("steady step %s, 8 slots at %d cached tokens: %.3f ms per "
                "step waiting for each step's tokens (%.1f tok/s), %.3f ms "
                "per step back to back; device busy %s ms per step (idle "
                "share %s); decode_step_model roofline %.3f ms (%.1f MB/step "
                "at 3.35 TB/s) = %.1f%% of the step [%s]"
                % (qz, cached, host_ms, cfg.max_seqs / host_ms * 1e3, b2b_ms,
                   "not measured" if dev_ms is None else "%.3f" % dev_ms,
                   "not measured" if dev_ms is None
                   else "%.3f" % (1 - dev_ms / host_ms), roof_ms,
                   m["hbm_bytes"] / 1e6, 100 * roof_ms / host_ms, card))

    with phase("6 flash kernels vs plain"):
        flash_tf32_cases(torch, kernels, card)
        rows += phase_flash(torch, kernels, F, timer, card)

    with phase("7 training step card vs cpu"):
        phase_train_parity(torch, get_symbol, ShardedTrainer, card)

    with phase("8 training at full width"):
        launches["train"], trainer_ms = phase_train(
            torch, kernels, get_symbol, ShardedTrainer,
            transformer_flops_per_step, card)

    with phase("9 embedding kernels vs plain"):
        rows += phase_embedding(torch, kernels, sk, timer, card)

    with phase("10 recommender step card vs cpu"):
        phase_rec_parity(torch, tsp, MeshSpec, make_mesh, convert, card)

    rec_ms = {}
    with phase("11 recommender at full width"):
        launches["recommender"], rec_ms["bench"] = rec_run(
            torch, kernels, tsp, MeshSpec, make_mesh, REC, 3, 20, card)
        torch.cuda.empty_cache()
        launches["criteo"], rec_ms["criteo"] = rec_run(
            torch, kernels, tsp, MeshSpec, make_mesh, CRITEO, 2, 5, card)
        torch.cuda.empty_cache()

    with phase("12 two-bit kernel vs plain"):
        rows += phase_two_bit(torch, kernels, timer, card)
        del timer
        torch.cuda.empty_cache()

    with phase("13 Module step card vs cpu"):
        phase_module_parity(torch, mx, kernels, tkv, get_symbol, card)

    with phase("14 Module.fit at full width"):
        launches["module"] = phase_module_fit(torch, mx, kernels, tkv,
                                              get_symbol, trainer_ms, card)
        torch.cuda.empty_cache()

    with phase("15 rtc kernels vs plain"):
        timer = Timer(torch)
        rtc_rows, _, _ = phase_rtc(torch, mx, kernels, tc, timer, card)
        rows += rtc_rows
        torch.cuda.empty_cache()

    with phase("16 nd ops card vs cpu"):
        phase_nd_parity(torch, tc, card)

    with phase("17 imperative path at full width"):
        launches["imperative"], row = phase_imperative(
            torch, mx, kernels, tc, get_symbol, timer, card)
        rows.append(row)
        torch.cuda.empty_cache()

    with phase("18 conv nets card vs cpu"):
        phase_convnet_parity(torch, mx, ShardedTrainer, convert, card)

    with phase("19 ResNet-50 at full width"):
        launches["resnet"] = phase_resnet50(torch, kernels, ShardedTrainer,
                                            card)
        torch.cuda.empty_cache()

    with phase("20 flash kernels in bf16 (B9) vs plain"):
        timer = Timer(torch)
        rows += phase_flash_16(torch, kernels, F, timer, card, "bf16")
        del timer
        torch.cuda.empty_cache()

    with phase("21 the LM in bf16"):
        lm_bf16, lm_bf16_ms = phase_lm_16(
            torch, kernels, get_symbol, ShardedTrainer, sgd_step_fn,
            transformer_flops_per_step, card, "bf16")
        launches["lm_bf16"] = lm_bf16["sgd_step_fn"]
        log("LM per step: f32 ShardedTrainer.step %.2f ms (phase 8), bf16 "
            "sgd_step_fn %.2f ms, bf16 build_step_auto_layout %.2f ms [%s]"
            % (trainer_ms, lm_bf16_ms["sgd_step_fn"],
               lm_bf16_ms["build_step_auto_layout"], card))

    with phase("22 ResNet-50 in bf16"):
        launches["resnet_bf16"] = phase_resnet50_bf16(
            torch, kernels, ShardedTrainer, sgd_step_fn, card)
        torch.cuda.empty_cache()

    with phase("23 two-bit kernel in f16, bf16, f64 (B10) vs plain"):
        timer = Timer(torch)
        rows += phase_two_bit_dtypes(torch, kernels, timer, card)
        del timer
        torch.cuda.empty_cache()

    with phase("24 ResNet-50 in float16 through Module.fit"):
        launches["module_f16"] = phase_module_f16(torch, mx, kernels, tkv,
                                                  card)

    with phase("25 flash kernels in f16 (B9 f16) vs plain"):
        timer = Timer(torch)
        rows += phase_flash_16(torch, kernels, F, timer, card, "f16")
        del timer
        torch.cuda.empty_cache()

    with phase("26 the LM in float16"):
        lm_f16, lm_f16_ms = phase_lm_16(
            torch, kernels, get_symbol, ShardedTrainer, sgd_step_fn,
            transformer_flops_per_step, card, "f16")
        launches["lm_f16"] = lm_f16["sgd_step_fn"]
        log("LM per step: bf16 sgd_step_fn %.2f ms, build_step_auto_layout"
            " %.2f ms (phase 21); f16 sgd_step_fn %.2f ms, "
            "build_step_auto_layout %.2f ms [%s]"
            % (lm_bf16_ms["sgd_step_fn"],
               lm_bf16_ms["build_step_auto_layout"],
               lm_f16_ms["sgd_step_fn"],
               lm_f16_ms["build_step_auto_layout"], card))
        torch.cuda.empty_cache()

    with phase("27 embedding kernels in bf16, f16, f64 (B11) vs plain"):
        timer = Timer(torch)
        rows += phase_embedding_b11(torch, kernels, sk, timer, card)
        del timer
        torch.cuda.empty_cache()

    with phase("28 the recommender on bf16 tables"):
        phase_rec_bf16_parity(torch, tsp, MeshSpec, make_mesh, convert,
                              card)
        for tag, geo, warm, timed in (("bench", REC, 3, 20),
                                      ("criteo", CRITEO, 2, 5)):
            got, ms = rec_run(torch, kernels, tsp, MeshSpec, make_mesh, geo,
                              warm, timed, card, dtype="bfloat16")
            launches["rec_bf16_" + tag] = got
            log("recommender %s: bf16 tables %.3f ms per step (%.1f "
                "examples/s), f32 tables %.3f ms (%.1f examples/s, phase "
                "11) [%s]" % (tag, ms, geo["batch"] / ms * 1e3,
                              rec_ms[tag], geo["batch"] / rec_ms[tag] * 1e3,
                              card))
            torch.cuda.empty_cache()

    with phase("29 the optimizers and checkpoints through Module.fit"):
        phase_optimizers_parity(torch, mx, get_symbol, card)
        launches["module_adam"] = phase_adam_fit(torch, mx, kernels,
                                                 get_symbol, card)
        torch.cuda.empty_cache()
        phase_checkpoint_resume(torch, mx, get_symbol, card)

    with phase("30 BucketingModule and remat at full width"):
        launches["bucketing"] = phase_bucketing(torch, mx, kernels, F, card)

    with phase("31 autograd and Gluon at full width"):
        launches["gluon_flash"], launches["gluon"] = phase_gluon(
            torch, mx, kernels, convert, get_symbol, ShardedTrainer,
            trainer_ms, card)

    with phase("32 the recurrent stack: the word LM through Gluon, the "
               "bucketed FusedRNNCell LM"):
        kernels.reset_launches()
        phase_recurrent(torch, mx, convert, card)
        launches["recurrent"] = dict(kernels.LAUNCHES)

    with phase("33 the RNN op, linalg and the spatial ops card vs cpu"):
        phase_recurrent_ops(torch, mx, card)

    with phase("34 SSD at full width through Module.fit"):
        launches["ssd"], row = phase_ssd(torch, mx, kernels, card)
        rows.append(row)
        torch.cuda.empty_cache()

    with phase("35 the detection ops at realistic sizes and the five conv "
               "nets"):
        nms = phase_detection_ops(torch, kernels, card)
        for r in rows:
            if r["name"] == "greedy_nms_f64":
                r["proposal_nms"] = nms
        phase_more_nets(torch, kernels, ShardedTrainer, card)
        torch.cuda.empty_cache()

    with phase("36 sparse storage: the wide-embedding loop, CSR at Avazu's "
               "width, Module.fit of the SparseEmbedding classifier"):
        sparse_launches, sparse_rows = phase_sparse(torch, mx, kernels, card)
        for part, got in sparse_launches.items():
            launches["sparse_" + part] = got
        rows += sparse_rows
        torch.cuda.empty_cache()

    with phase("37 data IO: ResNet-50 from JPEG records through "
               "ImageRecordIter and Module.fit, Gluon through the "
               "DataLoader's workers, SSD through ImageDetIter"):
        kernels.reset_launches()
        phase_data_io(torch, mx, kernels, here, card)
        launches["data_io"] = dict(kernels.LAUNCHES)

    with phase("38 data parallelism across processes: Module.fit through "
               "dist_sync with 2-bit compression in two ranks, the dp and "
               "ZeRO ShardedTrainer, the recommender over a dp mesh, a "
               "Module over two contexts"):
        dist_launches, probes = phase_dist(torch, mx, kernels, tkv,
                                           get_symbol, here, card)
        for part, got in dist_launches.items():
            launches["dist_" + part] = got

    with phase("39 tensor parallelism: the tp ShardedTrainer on GPT-2-small "
               "over two ranks, tp-2 decode through the DecodeEngine, B3 "
               "and B4 at the per-rank shapes, ctx_group through "
               "Module.fit"):
        tp_rows, tp_launches = phase_tp(torch, mx, kernels, here, probes,
                                        card)
        rows += tp_rows
        for part, got in tp_launches.items():
            launches["tp_" + part] = got

    with phase("40 ring attention, the GPipe schedule, MoE dispatch and "
               "the two-tier all-reduce, each over one mesh axis's group"):
        step2_rows, step2_launches = phase_step2(torch, mx, kernels, here,
                                                 probes, card)
        rows += step2_rows
        for part, got in step2_launches.items():
            launches["step2_" + part] = got

    # -- report ---------------------------------------------------------------
    for r in rows:
        key = r["name"]
        r["launches"] = sum(v.get(key, 0) for v in launches.values())
    log("total %.1f s" % (time.perf_counter() - t_start))
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
