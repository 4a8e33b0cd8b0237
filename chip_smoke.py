"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py [--profile]

Main paths: Bayesian ResNet-50 (reparameterization) on seeded random
weights and images, 224x224, 1000 classes, bf16 compute:

- inference: eval mode, ``mc_forward`` with 10 weight draws at batch 128;
- training: the ELBO train step ``examples._engine.make_train_step`` with
  4 draws at batch 128, SGD(0.01, momentum 0.9), the head through the fused
  sampled GEMM (``fc.impl="pallas"``), draws inside the layers;
- the trainer ``examples/main_bayesian_imagenet.py`` at batch 32, f32:
  train, resume, test;
- INT8 serving: ``qresnet50`` (f32 float model, calibrated on 3 batches of
  32 images, converted with conv+BN folding and uint8 activations), MC-10
  at batch 128, then frozen-draw MC-1, then the uncalibrated model's
  MC-1; every conv and the head through the fused int8 GEMM (K-F);
- the vmap emission (``emission="vmap"``: all draws in one forward, draw s
  in channel block s, every conv one grouped conv): MC-10 bs128 inference
  and the MC-4 bs128 ELBO step, the head through K-B with lanes (and K-D,
  K-E with lanes backward);
- the pointwise emission (``ops.conv.CONV_1X1_DOT = True``): the same vmap
  MC-10 bs128 inference with every 1x1 stride-1 conv through the per-draw
  GEMM kernel K-G;
- Flipout ResNet-50 (``resnet_flipout_large.resnet50``): MC-10 bs128
  inference and MC-4 bs128 ELBO steps, through the draw loop and through
  the vmap emission, and one vmap batch with the pointwise emission (the
  mean convs through K-G at S = 1, the perturbation convs through K-G);
  the signs hashed inside the sign flip and the combine (K-H1, K-H2; the
  INT8 layers' input sign product K-H3 and output sign product in K-F's
  Flipout epilogue, phases 38-40), checked at full width in phase 46;
- the small-model zoo: the ConvTranspose layers, the Bayesian CIFAR
  ResNet-110 trainer (f32, bs128, MC-50 evaluation), the Flipout CIFAR
  trainer, the deterministic CIFAR and MNIST trainers, the Bayesian MNIST
  trainer and the INT8 CIFAR and SCNN paths (phases 32-36);
- INT8 Flipout: ``quantized_resnet_flipout_large.qresnet50`` (the float
  Flipout ResNet-50 calibrated on 3 batches of 32 images, converted with
  conv+BN folding and uint8 activations), MC-10 at batch 128 (two K-F
  GEMMs a layer a draw: the mean, and the perturbation with the Flipout
  epilogue: its sign product and the add to the mean), then frozen
  perturbations at MC-1 and the uncalibrated model's MC-10; grouped and
  transposed int8 convs through K-F (phases 37-40);
- the Bayesian LSTM (config #4: batch 128, sequence 64, hidden 64, f32;
  the time-series trainer's regressor, LSTM(1 -> 64) + Linear(64 -> 2),
  both estimators): MC-20 inference through the draw loop and the vmap
  emission, the quantized LSTM, the trainer and one launch script (phase
  41);
- the modes of phase 42: ResNet-50 MC-4 bs128 training steps with block
  remat (``remat_blocks`` True and "conv_out", the draws replayed in the
  recompute), ``structured=True``, both INT8 ``qresnet50`` models and the
  quantized LSTM under the draw axis, the trainer with ``--remat
  --structured-mc`` and a ``utils.profiling`` table;
- model surgery: the deterministic ResNet-50
  (``models/deterministic/resnet_large.py``), ``utils.MOPED`` into the
  Bayesian ResNet-50 and ``models.dnn_to_bnn`` of the deterministic one
  (MC-10 bs128 through K-A), the converted model's MC-4 bs128 ELBO steps
  (K-A and K-C through the vmap emission), the four surgery trainers
  (deterministic, ``--moped``, ``dnn2bnn``, ``bnn2qbnn`` through K-F) and
  ``graft_entry.entry()``;
- channels-last (phase 44): the same ResNet-50 built with
  ``data_format="NHWC"`` (inputs (B, 224, 224, 3)) through the loop, vmap,
  vmap with ``CONV_1X1_DOT`` (K-G channels-last) and ``structured=True``
  beside the NCHW model on the same weights, its MC-4 ELBO steps, Flipout
  and INT8 twins, and ``graft_entry.entry()`` at the flagship shape.

Phases, each printing its own line(s):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: the CUDA kernels compiled from ``bayesian_torch_tpu_torch/csrc``;
   each kernel's wgmma (HGMMA, IGMMA), mma.sync (HMMA) and TMA (UTMALDG,
   UBLKCP) instructions counted in ``cuobjdump -sass`` of the library:
   K-G's bf16 kernels and both instantiations of K-F (plain and with the
   Flipout epilogue) must hold wgmma and TMA loads, K-B, K-D and K-E a
   tensor-core product; the instruction mix (conversions, integer-pipe,
   FMA-pipe) of K-H3's two forms and of both K-F instantiations;
3. K-A (batch weight sampler) against its plain torch version at the
   ResNet-50 flat size (all Bayesian weights, 10 draws), f32 and bf16 out,
   eps moments; its rho mode (the single draw ``sample_gaussian``,
   softplus in the kernel) at the same size, one launch, f32 and bf16 out;
   device times (torch.profiler) of both in bf16 beside their plain
   versions, with the bound and its deciding term; two calls equal;
4. K-B (fused sampled GEMM) against its plain version at the head shape
   (M=128, K=2048, N=1000), f32 with TF32 off; two calls equal bit for bit;
   device times (torch.profiler) beside the plain version and the unfused
   route (K-A drawing the weight in f32, then ``torch.matmul``);
5. inference path: three batches through ``mc_forward(..., num_mc=10,
   reduce="mean")`` (presample "auto", i.e. K-A), one K-A launch per
   batch, predictive entropy, ms per batch and images/s;
6. the head through K-B (``fc.impl = "pallas"``, ``presample="off"``): ten
   K-B launches for one batch; then a sanity run at rho = -30 where ten
   draws must agree with a single draw;
7. the backward kernels against their plain versions at full shapes: K-C
   (dsigma mode, n = all Bayesian weights, S = 4, bf16 g; rho mode, S = 1,
   f32 g; device times as in phase 4), then K-A and K-C at each of the 54
   per-layer buffers of the training steps, and dsigma of ones against the
   sum of K-A's draws (bit for bit); K-D and K-E at the head shape, f32
   with TF32 off, device times as in phase 4 (each beside its unfused
   route: K-E's is ``torch.matmul`` over the S*M rows for dmu, K-A's eps
   and ``torch.bmm`` per lane for dsigma, held to the same gate), two
   calls equal; and ``torch.autograd.grad`` through the public
   ops against autograd through their plain versions;
8. training path (the draw loop, ``emission="scan"``; ``"auto"`` trains
   through the vmap emission): one warm-up and three timed ELBO steps at
   MC-4 bs128:
   ms, images/s, loss, CE, KL and every kernel's launches per step (equal
   to the counts the model implies), finite and non-zero gradients, one
   BN EMA update per step; peak memory;
9. one training step with ``presample="on"``: one K-A and one K-C (dsigma)
   launch;
10. a training sanity check at rho = -30: an MC-4 step and an MC-1 step
    from the same state give the same mu gradients and running stats;
11. the trainer: ``--epochs=2``, then ``--resume --epochs=3`` (starts at
    epoch 2), then ``--mode=test``;
12. with ``--profile`` only: one inference batch and one training step
    under ``torch.profiler`` (device time, idle share, the top kernels),
    and the K-B kernel alone;
13. INT8 build: the float ResNet-50 takes BN statistics from one
    training-mode forward and gives its MC-10 predictive mean, then is
    calibrated and converted (54 quantized layers, all calibrated);
14. K-F against its plain version at every GEMM shape of one INT8 forward
    and at ragged shapes (M off the tile, N = 64 and 1000, the stem's
    K = 147), x_zp = 128 and x_zp = 117 with a bias, bit for bit; device
    times (torch.profiler) of the kernel, the plain version and
    ``torch._int_mm``, with the bound;
15. the INT8 main path: three MC-10 bs128 batches after a warm-up, 540 K-F
    launches each, ms per batch and images/s; top-1 agreement with the
    float model (printed, not gated); the weight build of one draw alone;
16. with ``--profile`` only: one INT8 MC-10 batch under the profiler;
17. frozen-draw MC-1 (``freeze_quantized_draws``), 54 launches per batch;
18. INT8 sanity: with frozen draws, the card's logits on 2 images against
    a CPU copy on the plain versions (activations into the pool bit for
    bit, logits within 3 head quanta); two unfrozen forwards differ;
19. the uncalibrated model (every tensor at scale 0.2, zp 128): MC-1;
20. K-B with lanes (S = 10) and K-D, K-E with lanes (S = 4) against their
    plain versions at the head shape, x per lane and x shared, f32 with
    TF32 off, device times beside the unfused route (K-E's held to the
    same gate), two calls equal; lane 0 (K-E: one lane) equal to the
    single-draw kernels bit for bit (run after phase 7);
21. the vmap inference path: three MC-10 bs128 batches after a warm-up,
    fc.impl="pallas", presample "auto" (off): ms per batch, images/s, peak
    memory, every kernel's launches per batch equal to what the model
    implies; lane for lane against the draw loop fed the same presampled
    draws; the rho = -30 check (run after phase 10);
22. the vmap training path: at rho = -60, in f32, a vmap MC-4 step and a
    loop MC-4 step from the untrained state agree, and so do a vmap step
    with ``CONV_1X1_DOT = True`` (K-G forward and K-G for dx, 66
    launches) and one on the default route (run before phase 8);
    after phase 10, one warm-up and three timed MC-4 bs128 ELBO steps,
    with the checks of phase 8 (launches per step: K-A and K-C dsigma
    once per layer, K-B, K-D and K-E with lanes once); then the same
    three steps with ``CONV_1X1_DOT = True`` (33 K-G launches forward and
    33 for the input gradients per step);
23. with ``--profile`` only: one vmap inference batch and one vmap
    training step under the profiler;
24. K-G (the per-draw GEMM) against its plain version at the 12 pointwise
    sites of ResNet-50 (S = 10, B = 128, bf16), its S = 1 wrapper at the
    same sites over the B*S batch, and its backward there (dx = w^T g,
    K-G on the transposed weight, and one autograd pass: two launches),
    with the device times of the S-way grouped cuDNN conv that
    ``conv_draws`` runs by default and of ``torch.matmul``; the
    shared-input and shared-weight cases with a bias (56x56, 14x14, 7x7)
    and a ragged case, bf16 and f32; the matmul probe's two shapes
    (4096^3 and 8192 x 4096 x 4096) in bf16 and int8 (bit for bit) beside
    ``torch.matmul`` and ``torch._int_mm`` (run after phase 20);
25. the pointwise emission: vmap MC-10 bs128 inference with
    ``CONV_1X1_DOT = True``, 33 K-G launches per forward, lane for lane
    against the default route on the same presampled draws, ms per batch
    beside the default's (run after phase 21);
26. Flipout ResNet-50: MC-10 bs128 inference through the loop and the vmap
    emission (ms per batch, images/s, peak memory, launches gated), vmap
    lane for lane against the loop under the same seeds, the rho = -30
    check, one vmap batch with ``CONV_1X1_DOT = True`` (33 K-G and 33
    K-G S = 1 launches) against the default route; MC-4 bs128 ELBO steps
    through the loop (``emission="scan"``) and the vmap emission (finite,
    non-zero gradients on
    every mu and rho, launches gated); K-H1 and K-H2 launches gated in
    every run (a flip and a combine a layer and forward, the backward's
    flips) and no sign hashed in torch on the card; with ``--profile`` one
    Flipout inference batch and one step under the profiler;
27. the deterministic ResNet-50 (seeded He init, BN statistics from one
    batch): f32 logits (TF32 off) against a CPU copy on 4 images, within
    2^-10 x max|logit|; bf16 forwards (conv and linear weights bf16, BN in
    f32) timed at bs128 and bs1280 (host clock to synchronize, median of
    5 after a warm-up, as phase 5 times its batches), and the
    10x-deterministic denominator min(t(bs1280), 10 x t(bs128)) beside the
    MC-10 loop batch of phase 5 and their ratio, with the card's name and
    power limit;
28. ``MOPED(resnet50, det, None, delta=1e-4)`` in f32: the MC-10 loop
    mean (presample on) within 2^-6 x max|logit| of the deterministic
    logits, one K-A launch, a finite ``get_kl_loss``; then ``dnn_to_bnn``
    of the deterministic model (MOPED, delta 1e-4) through the same gates,
    its ``state_dict`` keys those of ``resnet_variational_large.resnet50``;
29. a model converted at delta 0.5 (bf16 compute): three MC-4 bs128 ELBO
    steps through ``make_train_step`` (emission "auto", which takes vmap),
    finite losses, K-A and K-C (dsigma) launches as
    ``expected_vmap_launches`` reckons them;
30. the surgery trainers at batch 32, one epoch each:
    ``main_deterministic_imagenet`` (train, then test),
    ``main_bayesian_imagenet --moped`` from its checkpoint (K-A and K-C
    drho launched), ``main_bayesian_imagenet_dnn2bnn`` (train, then test)
    and ``main_bayesian_imagenet_bnn2qbnn --fuse-conv-bn
    --quantize-activations`` on its checkpoint (K-F launched, INT8
    accuracy in [0, 1]) (run after phase 11);
31. ``graft_entry.entry()``: its MC-2 forward at 64x64 on the card, the
    output's shape and finiteness;
32. (a) the small-model zoo, after the INT8 phases: the six
    ``ConvTranspose*`` layers on the geometry cases of
    ``tests/test_conv_ops.py`` with injected noise against a CPU copy
    (f32, TF32 off, 1e-4 x max|CPU|); a Conv -> ConvTranspose model's vmap
    MC-10 lane for lane against its loop on the same presampled draws;
33. (b) the Bayesian CIFAR ResNet-110 (16/32/64 wide) at bs128, 32^2, f32:
    ``main_bayesian_cifar --arch resnet110 --epochs 1`` (32 steps on the
    4096 synthetic images, then its MC-50 evaluation at bs1000; K-A and
    K-C drho launches exact: 111 each a step); ms per ELBO step at MC-1
    (loop) and MC-4 (emission "auto": vmap; 110 K-A and K-C dsigma a
    step), peak memory, device busy time and idle share of one step of
    each; ms per MC-50 batch at bs1000; rho = -30: the MC-50 mean within
    2^-6 x max|logit| of one draw; rho = -60, f32 TF32 off: a vmap MC-4
    step within 2^-6 of a loop step;
34. (c) ``main_bayesian_flipout_cifar --arch resnet20 --epochs 1
    --num_monte_carlo 4`` (launches exact) and its MC-1 step timed;
35. (d) ``main_deterministic_cifar --arch resnet20``,
    ``main_deterministic_mnist`` and ``main_bayesian_mnist`` (bs64, one
    epoch, MC-20 evaluation) with every step timed; the SCNN's vmap MC-4
    log-probabilities sum to 1 in every draw;
36. (e) ``main_bayesian_cifar_dnn2bnn --mode=ptq --arch resnet20`` (K-F
    launches exact) and ``quantization_test``; a calibrated INT8 CIFAR
    ResNet-20 (conv+BN folding, uint8 activations): K-F bit for bit at its
    bs128 GEMM shapes and at the SCNN's (device times as in phase 14),
    INT8 MC-20 bs1000 timed, and its logits with frozen draws against a CPU
    copy (the activations out of layer3 bit for bit, the logits within 3
    head quanta). Each zoo phase logs its seconds.
37. INT8 Flipout build: the float Flipout ResNet-50 (f32) takes BN
    statistics from one batch, calibrates on 3 x 32 images (the Flipout
    calibration forward) and is converted (conv+BN folding, uint8
    activations): 54 quantized Flipout layers with 10-slot quant_dicts;
38. the INT8 Flipout main path: three MC-10 bs128 batches after a
    warm-up, 540 plain K-F launches (the means) and 540 with the Flipout
    epilogue (the perturbations, their output signs and the add) each, ms
    per batch, images/s, peak memory; one batch under the profiler (busy,
    idle share, K-F's, its epilogue's and K-H3's device time and share);
    frozen perturbations at MC-1 (54 + 54 launches a batch); the
    uncalibrated model's MC-10 (540 + 540 a batch); one K-H3 launch a
    layer and draw (the input's requantize and signs) in each, no sign
    hashed in torch, no torch qadd;
39. INT8 Flipout sanity: frozen perturbations, generators reseeded: the
    activations into the pool and the uint8 logits of 2 images equal a
    CPU copy's bit for bit (K-H3, 54 launches, and K-F's Flipout
    epilogue, 54, on the card against their plain versions on the CPU);
    two frozen-perturbation forwards differ;
40. grouped and transposed int8 convs: a ResNeXt-like 3x3 conv (256 ->
    256, 32 groups, 56^2, bs32; 32 K-F GEMMs) and DCGAN-like
    ``QuantizedConvTranspose2d{Reparameterization,Flipout}`` layers (512
    -> 256, k4 s2 p1, 16^2, bs64) on the card, bit for bit with the plain
    route (K-F's plain version in the same lowering) and with a float64
    conv's integer sum; the grouped conv again with the Flipout epilogue
    (32 GEMMs, each its group's columns of the mean and block of the
    signs), the Flipout transposed layer through it (its perturbation
    GEMM); device times of the route, K-F's rows and the plain route,
    with the bound. Phases 37-40 log their seconds.
41. the Bayesian LSTM at config #4's full width (bs128, seq 64, hidden
    64, f32), its parts' seconds logged: (a) K-A and K-C (dsigma) against
    their plain versions at its draw buffers (256 x 1, 256 x 64, 256)
    with T = 64 lanes and S*T = 1280; (b) one forward of each estimator's
    regressor on the card against a CPU copy (the same seeds), within
    1e-4 x max(1, max|CPU|); (c) at rho = -30 the LSTM against
    ``torch.nn.LSTM`` (batch-first, cuDNN) holding its means, within
    1e-5; (d) MC-20 bs128 inference through the loop (K-A 81 a batch: the
    head's presample and 4 a draw) and the vmap emission (K-A 5 a batch),
    each estimator: ms per batch (median of 5, min, max), busy ms, idle
    share of the median, the Flipout LSTM's K-H1 (its four sign blocks a
    forward) and its head's K-H1, K-H2 gated; (e) the quantized
    LSTM (``bnn_to_qbnn``) at MC-20 through the loop (K-F 20 a batch, the
    head); (f) ``main_bayesian_lstm_timeseries`` at batch 128 for 40
    steps, then ``--mode=test``, each estimator: the loss falls, RMSE and
    2-sigma coverage printed, launches exact; (g)
    ``scripts/train_flipout_mnist.sh`` end to end at its smallest
    synthetic overrides.
42. the modes (``phase_modes``, after phase 41, its parts' seconds
    logged): (a) K-A and K-C against their plain versions at the
    residual blocks' draw buffers; ResNet-50 MC-4 bs128 224² bf16
    (``fc.impl="pallas"``) through vmap and the loop: from one state and
    generator state, the loss, every gradient and the running statistics
    of a ``remat_blocks=True`` and a ``"conv_out"`` step within 2^-6 of
    each tensor's largest value of the step without remat,
    ``num_batches_tracked`` exact, the peak memory (``max_memory_allocated``)
    of each, lower with remat; three timed steps of each mode with the
    launches gated (``expected_remat_launches``: vmap K-A 106 and K-C
    dsigma 54, the loop K-A 424 and K-C drho 216); (f) one remat step
    under ``utils.profiling.trace`` and ``summarize_trace``'s table;
    (b) MC-10 bs128 ``structured=True`` equal to ``emission="vmap"``
    exactly on the same seeds; (c) ``qresnet50`` and its Flipout twin at
    MC-10 bs128 through the loop and under the draw axis on the same
    presample record, lane for lane bit for bit, K-F 540 and 1,080 a
    batch each way; (d) the quantized LSTM at config #4, five MC-20
    batches through the loop and under the draw axis, interleaved, K-F 20
    a batch, medians, min and max, busy ms and idle share; (e)
    ``main_bayesian_imagenet --remat --structured-mc --synthetic
    --batch-size=32 --epochs=1`` with its launches exact.
43. the mesh paths (``phase_multirank``, after phase 42, its parts'
    seconds logged), ResNet-50 MC-10 bs128 224² bf16 eval from one saved
    state and generator state: (a) ``parallel.initialize`` in this
    process, an NCCL world of one (one all-reduce), ``mc_forward(mesh=
    make_mesh(mc=1))`` against the same forward without a mesh; (b) two
    ranks on the one card (gloo; NCCL refuses two ranks on one device),
    each checked against the one-process run: ``mc=2`` through the loop
    (5 lanes a rank, one windowed K-A launch a rank), ``data=2`` (64 rows
    a rank), ``mc=2`` through the vmap emission with
    ``CONV_1X1_DOT = True`` (K-G), an MC-4 bs128 vmap SGD step at
    ``mc=2`` (the parameters against the one-process step's, K-C dsigma
    on both ranks; in f32 with TF32 off against the one-process step, in
    bf16 against its twin whose draw-axis convs run in two groups of S =
    2, a rank's shapes, and against the S = 4 step at that twin's distance
    from it) and an MC-2 bs32 loop step (K-C drho); (c)
    ``shard_params_tp`` over ``model=2`` at full widths, MC-2 bs8, against
    the replicated model; the twin of ``dryrun_multichip(2)`` on the card
    (resnet20 step, INT8 QBNN through K-F, structured Flipout, the loop);
    (d) ``main_bayesian_imagenet --mesh-mc=2 --synthetic --batch-size=32
    --num_mc=2`` for two epochs, then ``--epochs=3 --resume``: both ranks
    end with the same weights; (e) the native ``DataLoader``
    (``native_available()`` asserted) feeding one epoch of 224² bs128
    images to the card, beside the numpy path, in batches per second;
    (f) the LSTM regressor at config #4 (MC-20 bs128, seq 64, hidden 64,
    f32), from one state and generator state per model: K-A over a rank's
    lanes and a 'model' shard's rows and K-C dsigma on the same windows
    at the LSTM's buffers against their plain versions and the whole
    launch; then on the two ranks, each estimator against one process:
    ``mc=2`` through the loop (every draw on every rank, K-A 81) and the
    vmap emission (K-A 5 over 10 x 64 lanes), ``data=2`` (64 rows a rank,
    within 64 f32 ulps of max|out|), an MC-4 vmap SGD step and an MC-2
    loop step at ``mc=2`` (parameters within 1/256 of the update; K-C
    dsigma, and drho for the head in the loop), ``shard_params_tp`` over
    ``model=2`` (12 tensors, the LSTM gathered, the head column-parallel);
    the quantized LSTM at ``mc=2`` through the loop (K-F 20 a rank);
    (g) the head on the fused sampled GEMM (``fc.impl="pallas"``): K-B,
    K-D and K-E under the counter windows a rank draws (its lanes of the
    MC-10 and MC-4 launches, a 'model' shard's rows [500, 1000) at one
    draw and at MC-2) against their windowed plain versions at the head
    (1e-4 x max(1, max|plain|)), a rank's lanes equal to the whole
    launch's bit for bit; then on the two ranks ``mc=2`` and ``data=2``
    through the vmap emission at MC-10 bs128 (one K-B with lanes a rank)
    and the f32 MC-4 bs128 vmap SGD step at ``mc=2`` (K-B, K-D and K-E
    with lanes once each a rank; parameters within 1/256 of the update).
44. channels-last (``phase_nhwc``, last, its parts' seconds logged): (a)
    K-G channels-last (``mc_gemm_cl``: x (M, S, C), w (S, O, C)) against
    its plain version at the 12 pointwise sites of phase 24 (S = 10, B =
    128, bf16), within one bf16 ulp of the largest value; its dx (the
    kernel on the transposed weight, and one autograd pass: two launches)
    and the S = 1 wrapper at S = 1 and over the B*S rows; device times
    beside ``torch.einsum``, with the bound; (b) ResNet-50 MC-10 bs128
    224² bf16 NHWC against the NCHW model on the same weights and draws:
    the loop, vmap, vmap with ``CONV_1X1_DOT`` (33 K-G cl launches a
    batch) and ``structured=True`` (equal to vmap bit for bit), within
    2^-6 x max|logit| of NCHW; ms per batch of each layout and the cuDNN
    NCHW<->NHWC transpose kernels of one profiled batch of each; (c) MC-4
    bs128 ELBO steps through the loop, vmap and vmap with
    ``CONV_1X1_DOT`` (K-G cl forward and dx) in both layouts from one
    state: finite gradients, ms per step, the first losses; (d) Flipout
    MC-10 vmap in both layouts, and one NHWC batch with ``CONV_1X1_DOT``
    (33 K-G cl and 33 K-G cl S=1 launches); (e) ``qresnet50`` calibrated
    NCHW and its NHWC twin holding the same int8 state: MC-10 bs128 on the
    same draws, the activations into the pool and the mean logits bit for
    bit, 540 K-F launches a batch each; (f) ``graft_entry.entry()`` with
    ``BTT_ENTRY_FLAGSHIP=1``: NHWC (128, 224, 224, 3), MC-10 bf16.
45. channels-last on the mesh paths (``phase_nhwc_mesh``, last):
    ResNet-50 NHWC MC-10 bs128 224² bf16 from one saved state and
    generator state, two ranks on the one card (gloo), each against one
    process: ``mc=2`` through the presampled loop (one windowed K-A
    launch a rank), ``data=2``, ``mc=2`` through the vmap emission with
    ``CONV_1X1_DOT`` (33 K-G cl launches a rank, on its 5 lanes), an
    MC-4 bs128 vmap SGD step at ``mc=2`` in f32 without TF32 (parameters
    within 1/256 of the update), ``shard_params_tp`` over ``model=2`` at
    MC-2 bs8 (channels gathered on the last dim), the same with the head
    on the fused sampled GEMM (the shard's rows of the whole weight's
    counters) through the vmap emission (one K-B with lanes a rank) and
    the loop with ``presample="off"`` (a single-draw K-B a draw), and the
    NHWC structured-Flipout Net of ``dryrun_multichip`` under ``mc=2``
    (1e-5).
46. K-H, the Flipout signs inside their products (``phase_signs``, right
    after phase 26): K-H1 (x * signs) and K-H2 (mean + pert * signs) bit
    for bit with their plain versions at the 54 layers' activations of
    ResNet-50 MC-10 bs128 under the draw axis (bf16; one layer in f32), at
    a rank's rows under ``data=2`` and a shard's output channels under
    ``model=2`` (NCHW and NHWC), K-H1 writing the LSTM's sign blocks of a
    rank, and K-H3 at the 108 uint8 sign products of one INT8 Flipout
    forward (calibrated and default scales); the INT8 layers' fused forms
    at the 54 layers of the Flipout ``qresnet50`` at bs128: K-H3's input
    pass (a QTensor payload requantized and multiplied by its signs; x_q
    and the product) and K-F's Flipout epilogue (the perturbation GEMM,
    its output signs from the GEMM's counter map, the add to the mean),
    in the loop's form and the draw axis's (lanes 0 and 9 of 10), NCHW and
    NHWC, and under a window of rows; then the device time of one MC-10
    batch's sign work through the loop (540 flips, 540 combines, 1,080
    INT8 products, 540 input passes; ``kernel_times.sign_work``) and of
    one forward's 54 perturbation GEMMs with the Flipout epilogue
    (``kernel_times.flipout_gemm_work``) beside the plain versions' (CUDA
    events), the route before the epilogue (K-F, K-H3, torch's qadd) and
    the bound.

The line before the last is a JSON object with every kernel's launches,
counted from zero in the run named by its ``run`` key, its error against
its plain version and both times; K-A, K-C and K-F also carry ``paths``,
their launches on each path of the zoo, of phase 41 (K-A, K-C) and of
phase 42 (K-F: and of the INT8 main paths and phases 38-40), each
counted from zero; K-B, K-D and K-E (and their lane forms) their
launches a rank on the mesh paths of phases 43 and 45, and the single
draws their largest windowed error of phase 43 (g) (``window_err``); K-H1
and K-H2 their launches in phase 26's vmap batches (``paths``); K-F's
Flipout epilogue its launches in phase 38's batches, its other INT8
Flipout paths under ``paths``; the
last line is ``{"ok": true, "device": {...}}``, printed only after every phase
passed. Any failure raises and exits non-zero, as does a machine without
CUDA.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

# K-B, K-D, K-E, K-F and K-G are timed by their device time
# (device_times): their wrappers' host time and small torch ops (K-B's
# softplus, K-F's column sums) would swamp a single call timed by CUDA
# events
from kernel_times import (BF16_OPS, F32_OPS, HBM_BPS, INT8_OPS, KA_TAG,
                          KB_TAG, KC_TAG, KD_TAG, KE_TAG, KF_FLIP_TAG,
                          PER_NORMAL, QSIGN_SCALES, QSIGN_TAG, SESSIONS,
                          SIGN_TAG, TF32_OPS, device_times,
                          flipout_gemm_work, generation_ms, layer_sizes,
                          resnet50_gemms, resnet50_sites, sign_bound,
                          sign_work, unfused_dw)
from kernel_times import SITES as POINTWISE_SITES

BATCH = 128
NUM_MC = 10
TRAIN_MC = 4
TRAINER_BATCH = 32
IMAGE = 224
SEED = 0
REPS = 5
CALIB_BATCH = 32
INT8_LAYERS = 54  # ResNet-50: 53 convs and the head, one K-F launch each

N_POINTWISE = sum(count for *_, count in POINTWISE_SITES)  # 33


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def cuda_ms(fn):
    """Milliseconds of one call of ``fn`` on the card (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, reps=REPS):
    """Median time of ``fn`` on the card after one warm-up call."""
    fn()
    return statistics.median(cuda_ms(fn) for _ in range(reps))


def wall_ms(fn, reps=REPS):
    """Median host-clock time of ``fn`` to ``torch.cuda.synchronize()``
    after one warm-up call, as ``timed_mc`` times a batch."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes, ops, peak_ops):
    """(bound_ms, bound_by): the least time for moving ``nbytes`` (each
    input read once, each output written once) and doing ``ops`` at the
    card's peak rates, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def with_bound(what, res, nbytes, ops, peak_ops=F32_OPS, library_ms=None,
               normals=0):
    """``res`` with the bound and library entries of the kernels line. A
    sampling kernel's operations also bound it by the instructions of the
    ``normals`` counter-hash normals it draws, at the card's issue rate;
    the log names the term that decides."""
    terms = dict(bytes=nbytes / HBM_BPS * 1e3, product=ops / peak_ops * 1e3)
    if normals:
        terms["generation"] = generation_ms(normals)
    term = max(terms, key=terms.get)
    log(f"[bound] {what}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in terms.items()) + f"; bound by {term}"
        + (f" ({normals} normals x {PER_NORMAL} instructions)"
           if term == "generation" else ""))
    return dict(res, bound_ms=terms[term],
                bound_by="bytes" if term == "bytes" else "operations",
                library_ms=library_ms)


def bf16_ulp(x):
    """One bf16 ulp of |x| (8 significant bits) for normal values."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def card():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device():
    import torch

    log(card())
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return name


def template_args(tail):
    """The template arguments at the start of the tail of a mangled name
    (after the function's own name): integer literals (Li8E, Lb1E), class
    names (13__nv_bfloat16) and builtin types (f); None if there are none
    or one of another kind."""
    import re

    if not tail.startswith("I"):
        return None
    builtin = dict(f="float", d="double", i="int", b="bool")
    out, i = [], 1
    while i < len(tail) and tail[i] != "E":
        if tail[i] == "L":
            j = tail.index("E", i)
            out.append(tail[i + 2:j])
            i = j + 1
        elif tail[i].isdigit():
            n = re.match(r"\d+", tail[i:]).group()
            i += len(n)
            out.append(tail[i:i + int(n)])
            i += int(n)
        elif tail[i] in builtin:
            out.append(builtin[tail[i]])
            i += 1
        else:
            return None
    return out


def phase_build():
    from bayesian_torch_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path, nvcc_s, out = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in out.splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"[build] {path.name}: nvcc {nvcc_s:.1f} s, load "
        f"{time.perf_counter() - t0:.1f} s in all")
    for ln in regs:
        log(f"[build] ptxas: {ln}")
    sass_census(path)


def sass_census(path):
    """Which Hopper instructions each kernel of the built library holds,
    from ``cuobjdump -sass``: HGMMA and IGMMA (wgmma, bf16 and int8), HMMA
    (mma.sync), UTMALDG and UTMASTG (TMA tensor loads and stores), UBLKCP
    (bulk copies). K-G's bf16 lane and K-F must hold wgmma and TMA loads,
    K-G channels-last's two tile widths TMA stores too; K-B, K-D and every
    instantiation of K-E a tensor-core product (HGMMA or HMMA)."""
    import re
    from pathlib import Path

    from bayesian_torch_tpu_torch.ops.cuda import _build

    names = set()
    for src in _build._sources():
        names.update(re.findall(r"(\w+_kernel)\(", src.read_text()))
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    ops = ("HGMMA", "IGMMA", "HMMA", "UTMALDG", "UTMASTG", "UBLKCP")
    census, mixes, fn, mix = {}, {}, None, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            mangled = ln.split("Function :")[1].strip()
            fn = max((n for n in names if n in mangled), key=len,
                     default=mangled)
            args = template_args(mangled.split(fn, 1)[-1])
            if args:
                fn += "<" + ",".join(args) + ">"
            census[fn] = dict.fromkeys(ops, 0)
            mix = mixes.setdefault(sass_form(mangled), {}) \
                if sass_form(mangled) else None
        elif fn is not None:
            for op in ops:
                census[fn][op] += op in ln
            if mix is not None:
                count_instruction(mix, ln)
    for fn, c in sorted(census.items()):
        log(f"[build] SASS {fn}: " + ", ".join(f"{op} {n}"
                                                for op, n in c.items()))
    for form, mix in sorted(mixes.items()):
        log(f"[build] SASS mix {form}: " + ", ".join(
            f"{k} {v}" for k, v in mix.items()))
    SASS_MIX.update(mixes)
    for kernel, mma in (("mc_gemm_wgmma_kernel", "HGMMA"),
                        ("mc_gemm_xres_kernel", "HGMMA"),
                        ("qmatmul_wgmma_kernel", "IGMMA")):
        found = [c for fn, c in census.items() if fn.startswith(kernel)]
        check(found and all(c[mma] > 0 and c["UTMALDG"] > 0 for c in found),
              f"{kernel}: no {mma} (wgmma) or UTMALDG (TMA) in its SASS")
    # K-F: both tile widths, plain and with the Flipout epilogue
    found = {fn for fn in census if fn.startswith("qmatmul_wgmma_kernel<")}
    check(found == {f"qmatmul_wgmma_kernel<{n},{e}>" for n in (64, 128)
                    for e in ("BttNoEpilogue", "BttFlipEpilogue")},
          f"K-F's instantiations {sorted(found)}"
          ": want 64- and 128-wide tiles, each plain and with the Flipout "
          "epilogue")
    check(len(mixes) == 4, f"SASS mixes of {sorted(mixes)}: want K-H3's two "
          "forms and K-F's two instantiations (128-wide)")
    # K-G channels-last: both tile widths load and store by TMA
    found = [c for fn, c in census.items()
             if fn.startswith("mc_gemm_cl_wgmma_kernel")]
    check(len(found) == 2 and all(
        c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["UTMASTG"] > 0
        for c in found), "mc_gemm_cl_wgmma_kernel: want two instantiations "
          "with HGMMA (wgmma), UTMALDG and UTMASTG (TMA loads and stores)")
    # K-E's kernel is a template (<lanes, x's type>): every instantiation
    for kernel in ("sampled_matmul_kernel", "sampled_matmul_dx_kernel",
                   "sampled_matmul_dw_kernel"):
        found = [c for fn, c in census.items()
                 if fn == kernel or fn.startswith(kernel + "<")]
        check(found and all(c["HGMMA"] + c["HMMA"] > 0 for c in found),
              f"{kernel}: no tensor-core product (HGMMA, HMMA) in its SASS")


# the instruction mix of K-H3's forms and K-F's 128-wide instantiations in
# the built library ({form: {class: count}}), for the kernels line
SASS_MIX = {}
# SASS opcodes by the unit that issues them on Hopper: the conversion unit
# (16 a clock on an SM), the integer ALU (64), the FMA pipes (FP32 128,
# IMAD 64)
CONVERSIONS = ("I2F", "F2I", "FRND", "F2F", "I2I")
INTEGER = ("LOP3", "SHF", "PRMT", "IADD3", "ISETP", "SEL", "FSEL", "FMNMX",
           "LEA", "IABS", "IMNMX", "FSETP", "LOP")
FMA = ("FADD", "FMUL", "FFMA", "IMAD")


def sass_form(mangled):
    """The name of the K-H3 form or K-F instantiation a mangled kernel
    name is, or None for the others."""
    if "QSignOpILb1E" in mangled and "sign_kernelIj" in mangled:
        return "K-H3 input pass (32-bit index)"
    if "QSignOpILb0E" in mangled and "sign_kernelIj" in mangled:
        return "K-H3 product (32-bit index)"
    if "qmatmul_wgmma_kernelILi128E15BttFlipEpilogue" in mangled:
        return "K-F 128 Flipout epilogue"
    if "qmatmul_wgmma_kernelILi128E13BttNoEpilogue" in mangled:
        return "K-F 128 plain"
    return None


def count_instruction(mix, line):
    """Add one SASS line's instruction (if it holds one) to ``mix``: the
    total and its unit's class."""
    import re

    m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                 line)
    if m is None:
        return
    op = m.group(1).split(".")[0]
    if op == "NOP":
        return
    mix["instructions"] = mix.get("instructions", 0) + 1
    for name, group in (("conversions", CONVERSIONS), ("integer", INTEGER),
                        ("fma", FMA)):
        if op in group:
            mix[name] = mix.get(name, 0) + 1


def flat_posterior(model):
    import torch

    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho
    from bayesian_torch_tpu_torch.parallel.mc import _posterior

    pairs = [_posterior(layer) for layer in iter_bayesian_layers(model)]
    with torch.no_grad():
        mu = torch.cat([m.reshape(-1) for m, _ in pairs])
        sigma = torch.cat([sigma_from_rho(r).reshape(-1) for _, r in pairs])
    return mu, sigma


def phase_batch_sampler(model):
    import torch

    from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
        sample_scaled_normals_batch as ka,
        sample_scaled_normals_batch_plain as ka_plain,
    )

    mu, sigma = flat_posterior(model)
    n = mu.numel()
    seed = 0x5EED_0000_0000_0001
    got = ka(seed, mu, sigma, NUM_MC, torch.float32)
    want = ka_plain(seed, mu, sigma, NUM_MC, torch.float32)
    err32 = (got - want).abs().max().item()
    del got, want
    got = ka(seed, mu, sigma, NUM_MC, torch.bfloat16)
    want = ka_plain(seed, mu, sigma, NUM_MC, torch.bfloat16)
    ulps = ((got.float() - want.float()).abs()
            / bf16_ulp(want)).max().item()
    del got, want
    eps = ka(seed + 1, torch.zeros_like(mu), torch.ones_like(sigma), NUM_MC,
             torch.float32)
    e_mean, e_std = eps.double().mean().item(), eps.double().std().item()
    e_max = eps.abs().max().item()
    del eps
    torch.cuda.synchronize()
    log(f"[K-A] n={n} S={NUM_MC}: f32 max|kernel-plain|={err32:.3e} "
        f"(limit 1e-5); bf16 max diff={ulps:.2f} ulp (limit 1); eps mean "
        f"{e_mean:.2e} std {e_std:.6f} max|eps| {e_max:.3f}")
    check(err32 <= 1e-5, "K-A f32 output differs from its plain version")
    check(ulps <= 1.0, "K-A bf16 output differs by more than one ulp")
    check(abs(e_mean) < 1e-3 and abs(e_std - 1) < 1e-3,
          "K-A eps moments are off")
    # the single draw: K-A in its rho mode takes softplus(rho) in the kernel
    from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
        sample_gaussian,
    )
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    rho = torch.log(torch.expm1(sigma))
    rho[:2] = torch.tensor([25.0, -40.0], device=rho.device)
    before = ka.launches
    got = sample_gaussian(seed, mu, rho, torch.float32)
    check(ka.launches == before + 1, "sample_gaussian: not one K-A launch")
    want = ka_plain(seed, mu, sigma_from_rho(rho), 1, torch.float32)[0]
    rho_err = max_err(got, want)
    got = sample_gaussian(seed, mu, rho, torch.bfloat16)
    want = ka_plain(seed, mu, sigma_from_rho(rho), 1, torch.bfloat16)[0]
    rho_ulps = ((got.float() - want.float()).abs()
                / bf16_ulp(want)).max().item()
    del got, want
    log(f"[K-A rho] the single draw (sample_gaussian, softplus in the "
        f"kernel), n={n}: f32 max|kernel-plain|={rho_err:.3e} (limit 1e-5); "
        f"bf16 max diff={rho_ulps:.2f} ulp (limit 1)")
    check(rho_err <= 1e-5, "K-A rho mode f32 differs from its plain version")
    check(rho_ulps <= 1.0, "K-A rho mode bf16 differs by more than one ulp")
    times = sampled_times(
        f"K-A S={NUM_MC} bf16",
        lambda: ka(seed, mu, sigma, NUM_MC, torch.bfloat16),
        lambda: ka_plain(seed, mu, sigma, NUM_MC, torch.bfloat16), None,
        KA_TAG)
    rho = torch.log(torch.expm1(sigma))
    rho_times = sampled_times(
        "K-A rho S=1 bf16",
        lambda: sample_gaussian(seed, mu, rho, torch.bfloat16),
        lambda: ka_plain(seed, mu, sigma_from_rho(rho), 1, torch.bfloat16),
        None, KA_TAG)
    with_bound("K-A rho S=1 bf16", {}, 10 * n, n, normals=n)  # its log line
    # no PyTorch call draws the counter-hash normals: no library time
    return with_bound(
        f"K-A S={NUM_MC} bf16", dict(
            max_abs_err=max(err32, rho_err), **times,
            **{f"rho_{k}": v for k, v in rho_times.items()}),
        (2 * 4 + 2 * NUM_MC) * n, 2 * NUM_MC * n, normals=NUM_MC * n)


def sampled_times(what, kernel, plain, unfused, tag):
    """Two calls of ``kernel`` give the same bits; device ms of the
    kernel (its rows named ``tag``), of its plain version and of the
    unfused route (K-A drawing the weights or, for K-E, eps in f32, then
    torch.matmul; all their device rows), logged. The plain version is no
    yardstick: it draws eps in torch passes."""
    import torch

    first = kernel()
    again = kernel()
    check(all(torch.equal(a, b) for a, b in zip(
        first if isinstance(first, tuple) else (first,),
        again if isinstance(again, tuple) else (again,))),
          f"{what}: two calls differ")
    keys = ("ms", "plain_ms", "unfused_ms")
    calls = [(kernel, tag), (plain, None)] + (
        [(unfused, None)] if unfused is not None else [])
    times = dict(zip(keys, device_times(*calls)))
    log(f"[{what}] device ms per call (torch.profiler, {len(times)} "
        f"routes): " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + "; two calls equal bit for bit")
    return times


def unfused_fwd(seed, x, mu, sigma, num_samples):
    """The route without the fused kernel: K-A draws the S weights in f32,
    torch.matmul multiplies (x (M, K) shared or (S, M, K))."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
        sample_scaled_normals_batch as ka,
    )

    return torch.matmul(x, ka(seed, mu, sigma, num_samples,
                              torch.float32).transpose(1, 2))


def unfused_dx(seed, g, mu, sigma):
    """K-D's function without the fused kernel: K-A, then torch.matmul."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
        sample_scaled_normals_batch as ka,
    )

    return torch.matmul(g, ka(seed, mu, sigma, g.shape[0], torch.float32))


def phase_sampled_gemm(model):
    import torch

    from bayesian_torch_tpu_torch.ops.cuda.sampled_matmul import (
        sampled_matmul as kb,
        sampled_matmul_plain as kb_plain,
    )
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    mu = model.fc.mu_weight.detach()
    rho = model.fc.rho_weight.detach()
    sigma = sigma_from_rho(rho)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(BATCH, mu.shape[1], generator=gen, device="cuda")
    seed = 4242
    with tf32_off():
        got = kb(seed, x, mu, rho, out_dtype=torch.float32)
        want = kb_plain(seed, x, mu, sigma, torch.float32)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"[K-B] M={BATCH} K={mu.shape[1]} N={mu.shape[0]} f32: "
            f"max|kernel-plain|={err:.3e}, limit 1e-4 x max|out| = "
            f"{1e-4 * scale:.3e} (split-TF32 products, order of summation)")
        check(err <= 1e-4 * scale, "K-B differs from its plain version")
        times = sampled_times(
            "K-B", lambda: kb(seed, x, mu, rho, out_dtype=torch.float32),
            lambda: kb_plain(seed, x, mu, sigma, torch.float32),
            lambda: unfused_fwd(seed, x, mu, sigma, 1)[0], KB_TAG)
    N, K = mu.shape
    # three TF32 products on the tensor cores (split TF32)
    return with_bound("K-B", dict(max_abs_err=err, **times),
                      4 * (BATCH * K + 2 * N * K + BATCH * N),
                      3 * 2 * BATCH * N * K, TF32_OPS, normals=N * K)


def set_bn_statistics(model, x):
    """Random weights would blow activations up through 50 layers of
    unnormalised eval-mode BN; take the running statistics from one
    training-mode forward of a batch instead."""
    import torch
    from torch import nn

    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: this batch's statistics
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()
    for m in bns:
        m.momentum = 0.1


def images(seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device="cuda")


def entropy(logits):
    p = logits.float().softmax(-1)
    return -(p * p.clamp_min(1e-30).log()).sum(-1).mean().item()


def phase_head(model, ka, kb, x):
    """One batch with the head through K-B (draws sampled in the layers);
    returns K-B's launches in that call alone."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    model.fc.impl = "pallas"
    ka.launches = 0
    kb.launches = 0
    try:
        t0 = time.perf_counter()
        out = mc_forward(model, x, NUM_MC, presample="off", reduce="mean",
                         return_kl=False)
        torch.cuda.synchronize()
        head_ms = (time.perf_counter() - t0) * 1e3
    finally:
        model.fc.impl = "xla"
    launches = kb.launches
    check(launches == NUM_MC, f"K-B launched {launches} times, want {NUM_MC}")
    check(tuple(out.shape) == (BATCH, 1000)
          and bool(torch.isfinite(out).all()), "K-B head output")
    log(f"[head] fc.impl='pallas', presample='off': {head_ms:.1f} ms for "
        f"one batch, K-B launches {launches} (and {ka.launches} S=1 K-A "
        f"launches for the in-layer conv draws), entropy {entropy(out):.4f}")
    return launches


@contextlib.contextmanager
def tf32_off():
    """f32 matmuls and convolutions in full f32 (TF32 off) inside."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def phase_noise_grad(model):
    """K-C in both modes against its plain version at ResNet-50's flat
    size: dsigma mode with S = 4 draws of bf16 g, rho mode with one f32
    draw."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    mu, sigma = flat_posterior(model)
    n = mu.numel()
    rho = torch.log(torch.expm1(sigma))
    check(max_err(sigma_from_rho(rho), sigma) <= 1e-6, "rho round trip")
    del mu, sigma
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    seed = 0x5EED_0000_0000_0002
    results = {}
    g = torch.randn((TRAIN_MC, n), generator=gen,
                    device="cuda").bfloat16()
    got, want = ka.dsigma(seed, g), ka.dsigma_plain(seed, g)
    err, scale = max_err(got, want), want.abs().max().item()
    del got, want
    log(f"[K-C dsigma] n={n} S={TRAIN_MC} bf16 g: max|kernel-plain|="
        f"{err:.3e}, limit 1e-5 x max|plain| = {1e-5 * scale:.3e}")
    check(err <= 1e-5 * scale, "K-C (dsigma) differs from its plain version")
    times = sampled_times(f"K-C dsigma S={TRAIN_MC} bf16 g",
                          lambda: ka.dsigma(seed, g),
                          lambda: ka.dsigma_plain(seed, g), None, KC_TAG)
    results["dsigma"] = with_bound(
        "K-C dsigma", dict(max_abs_err=err, **times),
        (2 * TRAIN_MC + 4) * n, 2 * TRAIN_MC * n, normals=TRAIN_MC * n)
    del g
    g = torch.randn(n, generator=gen, device="cuda")
    got, want = ka.drho(seed, g, rho), ka.drho_plain(seed, g, rho)
    err, scale = max_err(got, want), want.abs().max().item()
    del got, want
    log(f"[K-C drho] n={n} S=1 f32 g: max|kernel-plain|={err:.3e}, limit "
        f"1e-5 x max|plain| = {1e-5 * scale:.3e}")
    check(err <= 1e-5 * scale, "K-C (drho) differs from its plain version")
    times = sampled_times("K-C drho S=1 f32 g",
                          lambda: ka.drho(seed, g, rho),
                          lambda: ka.drho_plain(seed, g, rho), None, KC_TAG)
    results["drho"] = with_bound(
        "K-C drho", dict(max_abs_err=err, **times), 12 * n, 4 * n,
        normals=n)
    del g, rho
    layer_sweep(layer_sizes()[0], "ResNet-50's per-layer buffers")
    return results


def layer_sweep(sizes, what):
    """K-A and K-C against their plain versions at the draw buffers of
    ``sizes`` (elements: ResNet-50's 54 per-layer buffers of the training
    steps, ``kernel_times.layer_sizes``, or the zoo's): K-A in rho mode
    (S = 1; f32 in and out, and bf16 in and out as the draw loop runs it)
    and at S = 4 (bf16 out), K-C drho (S = 1; f32 g and rho, and bf16 as
    the draw loop runs it) and dsigma (S = 4, bf16 g); and, at the
    smallest buffer, the identity that ties backward to forward:
    dsigma of ones equals the sum of K-A's draws at mu = 0, sigma = 1 in
    f32, bit for bit."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    worst = dict.fromkeys(("K-A rho f32", "K-A rho bf16 (ulp)",
                           "K-A S=4 bf16 (ulp)", "K-C drho", "K-C drho bf16",
                           "K-C dsigma"), 0.0)

    def ulps(got, want):
        return ((got.float() - want.float()).abs()
                / bf16_ulp(want)).max().item()

    def rel(got, want):
        return max_err(got, want) / max(want.abs().max().item(), 1e-30)

    for i, n in enumerate(sizes):
        seed = 0x5EED_0000_0000_0100 + i
        mu = 0.1 * torch.randn(n, generator=gen, device="cuda")
        rho = torch.randn(n, generator=gen, device="cuda") - 3.0
        sigma = sigma_from_rho(rho)
        worst["K-A rho f32"] = max(worst["K-A rho f32"], max_err(
            ka.sample_gaussian(seed, mu, rho, torch.float32),
            ka.sample_scaled_normals_batch_plain(seed, mu, sigma, 1,
                                                 torch.float32)[0]))
        # the draw loop's operands: mu and rho in bf16, read as they are
        mu16, rho16 = mu.bfloat16(), rho.bfloat16()
        worst["K-A rho bf16 (ulp)"] = max(worst["K-A rho bf16 (ulp)"], ulps(
            ka.sample_gaussian(seed, mu16, rho16, torch.bfloat16),
            ka.sample_scaled_normals_batch_plain(
                seed, mu16, sigma_from_rho(rho16.float()), 1)[0]))
        worst["K-A S=4 bf16 (ulp)"] = max(worst["K-A S=4 bf16 (ulp)"], ulps(
            ka.sample_scaled_normals_batch(seed, mu, sigma, TRAIN_MC),
            ka.sample_scaled_normals_batch_plain(seed, mu, sigma,
                                                 TRAIN_MC)))
        g = torch.randn(n, generator=gen, device="cuda")
        worst["K-C drho"] = max(worst["K-C drho"], rel(
            ka.drho(seed, g, rho), ka.drho_plain(seed, g, rho)))
        g16 = g.bfloat16()
        worst["K-C drho bf16"] = max(worst["K-C drho bf16"], rel(
            ka.drho(seed, g16, rho16), ka.drho_plain(seed, g16, rho16)))
        g = torch.randn((TRAIN_MC, n), generator=gen,
                        device="cuda").bfloat16()
        worst["K-C dsigma"] = max(worst["K-C dsigma"], rel(
            ka.dsigma(seed, g), ka.dsigma_plain(seed, g)))
    n = min(sizes)
    ones = torch.ones((TRAIN_MC, n), device="cuda")
    draws = ka.sample_scaled_normals_batch(
        7, torch.zeros(n, device="cuda"), torch.ones(n, device="cuda"),
        TRAIN_MC, torch.float32)
    total = draws[0]
    for s in range(1, TRAIN_MC):
        total = total + draws[s]
    torch.cuda.synchronize()
    same = torch.equal(ka.dsigma(7, ones), total)
    log(f"[layers] K-A and K-C at {what}, {len(sizes)} sizes "
        f"({min(sizes)} to {max(sizes)} elements) against their plain "
        f"versions, worst: " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in worst.items())
        + f" (limits 1e-5, 1 ulp, 1 ulp, then 1e-5 x max|plain|); "
        f"dsigma of ones equals the sum of K-A's draws bit for bit: {same}")
    check(worst["K-A rho f32"] <= 1e-5, f"K-A rho mode f32 off at {what}")
    check(worst["K-A rho bf16 (ulp)"] <= 1.0
          and worst["K-A S=4 bf16 (ulp)"] <= 1.0,
          f"K-A bf16 more than one ulp off at {what}")
    check(max(worst["K-C drho"], worst["K-C drho bf16"],
              worst["K-C dsigma"]) <= 1e-5,
          f"K-C off its plain version at {what}")
    check(same, "dsigma(ones) differs from the sum of K-A's draws")


def phase_gemm_backward(model):
    """K-D and K-E against their plain versions at the head shape, f32
    with TF32 off."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    mu = model.fc.mu_weight.detach()
    sigma = sigma_from_rho(model.fc.rho_weight.detach())
    N, K = mu.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    g = torch.randn(BATCH, N, generator=gen, device="cuda")
    x = torch.randn(BATCH, K, generator=gen, device="cuda")
    seed = 4243
    flops = 2 * BATCH * N * K
    results = {}
    with tf32_off():
        got = kb.sampled_matmul_dx(seed, g, mu, sigma)
        want = kb.sampled_matmul_dx_plain(seed, g, mu, sigma)
        err, scale = max_err(got, want), want.abs().max().item()
        log(f"[K-D] dx: M={BATCH} N={N} K={K} f32: max|kernel-plain|="
            f"{err:.3e}, limit 1e-4 x max|plain| = {1e-4 * scale:.3e}")
        check(err <= 1e-4 * scale, "K-D differs from its plain version")
        times = sampled_times(
            "K-D", lambda: kb.sampled_matmul_dx(seed, g, mu, sigma),
            lambda: kb.sampled_matmul_dx_plain(seed, g, mu, sigma),
            lambda: unfused_dx(seed, g[None], mu, sigma)[0], KD_TAG)
        results["dx"] = with_bound(
            "K-D", dict(max_abs_err=err, **times),
            4 * (BATCH * N + 2 * N * K + BATCH * K), 3 * flops, TF32_OPS,
            normals=N * K)

        dmu, dsig = kb.sampled_matmul_dw(seed, g, x)
        dmu_w, dsig_w = kb.sampled_matmul_dw_plain(seed, g, x)
        err = max(max_err(dmu, dmu_w), max_err(dsig, dsig_w))
        scale = min(dmu_w.abs().max().item(), dsig_w.abs().max().item())
        log(f"[K-E] dmu, dsigma: M={BATCH} N={N} K={K} f32: "
            f"max|kernel-plain|={err:.3e}, limit 1e-4 x max|plain| = "
            f"{1e-4 * scale:.3e}")
        check(err <= 1e-4 * scale, "K-E differs from its plain version")
        # the draw loop's head input is bf16: read as it is, the same bits
        # as on its f32 copy
        xb = x.bfloat16()
        same = all(torch.equal(a, b) for a, b in zip(
            kb.sampled_matmul_dw(seed, g, xb),
            kb.sampled_matmul_dw(seed, g, xb.float())))
        log(f"[K-E] bf16 x equals its f32 copy bit for bit: {same}")
        check(same, "K-E on a bf16 x differs from K-E on its f32 copy")
        zeros, ones = torch.zeros_like(mu), torch.ones_like(mu)
        unf = unfused_dw(seed, g[None], x, zeros, ones)
        uerr = max(max_err(unf[0], dmu_w), max_err(unf[1], dsig_w))
        log(f"[K-E] unfused route: max|unfused-plain|={uerr:.3e}, limit "
            f"{1e-4 * scale:.3e}")
        check(uerr <= 1e-4 * scale,
              "K-E's unfused route differs from its plain version")
        times = sampled_times(
            "K-E", lambda: kb.sampled_matmul_dw(seed, g, x),
            lambda: kb.sampled_matmul_dw_plain(seed, g, x),
            lambda: unfused_dw(seed, g[None], x, zeros, ones), KE_TAG)
        # three TF32 products on the tensor cores (split TF32)
        results["dw"] = with_bound(
            "K-E", dict(max_abs_err=err, **times),
            4 * (BATCH * N + BATCH * K + 2 * N * K), 3 * flops, TF32_OPS,
            normals=N * K)
    return results


def phase_autograd(model):
    """torch.autograd.grad through the public ops on CUDA against
    autograd through their plain versions: the batch sampler (S = 4, bf16
    draws), the single-draw sampler and the sampled GEMM at the head."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb
    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    conv = model.layer4[0].conv2
    mu = conv.mu_kernel.detach().clone().requires_grad_(True)
    rho = conv.rho_kernel.detach().clone().requires_grad_(True)
    sigma = sigma_from_rho(rho.detach()).requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    worst = []

    def compare(name, got, want, tol):
        for a, b in zip(got, want):
            err, scale = max_err(a, b), b.abs().max().item()
            check(err <= tol * scale, f"autograd through {name} differs "
                  f"from its plain version ({err:.3e} > {tol} x {scale:.3e})")
            worst.append(err / max(scale, 1e-30))

    w = ka.sample_scaled_normals_batch(7, mu, sigma, TRAIN_MC)
    g = torch.randn(w.shape, generator=gen, device="cuda").bfloat16()
    compare("sample_scaled_normals_batch",
            torch.autograd.grad(w, (mu, sigma), g),
            torch.autograd.grad(ka.sample_scaled_normals_batch_plain(
                7, mu, sigma, TRAIN_MC), (mu, sigma), g), 1e-5)
    w = ka.sample_gaussian(8, mu, rho)
    g = torch.randn(w.shape, generator=gen, device="cuda").bfloat16()
    plain = ka.sample_scaled_normals_batch_plain(
        8, mu, sigma_from_rho(rho), 1)[0]
    compare("sample_gaussian", torch.autograd.grad(w, (mu, rho), g),
            torch.autograd.grad(plain, (mu, rho), g), 1e-5)
    fmu = model.fc.mu_weight.detach().clone().requires_grad_(True)
    frho = model.fc.rho_weight.detach().clone().requires_grad_(True)
    x = torch.randn(BATCH, fmu.shape[1], generator=gen, device="cuda",
                    requires_grad=True)
    g = torch.randn(BATCH, fmu.shape[0], generator=gen, device="cuda")
    with tf32_off():
        compare("sampled_matmul",
                torch.autograd.grad(kb.sampled_matmul(9, x, fmu, frho),
                                    (x, fmu, frho), g),
                torch.autograd.grad(kb.sampled_matmul_plain(
                    9, x, fmu, sigma_from_rho(frho), torch.float32),
                    (x, fmu, frho), g), 1e-4)
    log(f"[autograd] grad through sample_scaled_normals_batch (S="
        f"{TRAIN_MC}, n={mu.numel()}), sample_gaussian and sampled_matmul "
        f"(head) on CUDA equals grad through their plain versions: worst "
        f"max|diff| / max|plain| = {max(worst):.3e}")


def phase_lane_kernels(model):
    """K-B with lanes at S = 10 (MC-10 inference) and K-D, K-E with lanes
    at S = 4 (MC-4 training) against their plain versions at the head
    shape, x per lane and x shared, f32 with TF32 off; lane 0 (K-E: one
    lane) equals the single-draw kernel bit for bit; device times beside
    the unfused route."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    mu = model.fc.mu_weight.detach()
    rho = model.fc.rho_weight.detach()
    sigma = sigma_from_rho(rho)
    N, K = mu.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    seed = 4244
    results = {}

    def gate(name, got, want):
        err, scale = max_err(got, want), want.abs().max().item()
        check(err <= 1e-4 * scale, f"{name} differs from its plain version "
              f"({err:.3e} > 1e-4 x {scale:.3e})")
        return err, scale

    with tf32_off():
        S = NUM_MC
        x = torch.randn(S, BATCH, K, generator=gen, device="cuda")
        errs = []
        for what, xl in (("x per lane", x), ("x shared", x[0])):
            got = kb.sampled_matmul_batched(seed, xl, mu, rho, S)
            want = kb.sampled_matmul_batched_plain(seed, xl, mu, sigma, S)
            errs.append(gate(f"K-B lanes ({what})", got, want))
        check(torch.equal(got[0], kb.sampled_matmul(seed, x[0], mu, rho)),
              "K-B lanes: lane 0 differs from K-B")
        flops = 2 * S * BATCH * N * K
        log(f"[K-B lanes] S={S} M={BATCH} K={K} N={N} f32: max|kernel-plain|"
            f" = {errs[0][0]:.3e} (x per lane), {errs[1][0]:.3e} (x shared), "
            f"limit 1e-4 x max|plain| = {1e-4 * errs[0][1]:.3e}; lane 0 equal "
            f"to K-B")
        times = sampled_times(
            f"K-B lanes S={S}",
            lambda: kb.sampled_matmul_batched(seed, x, mu, rho, S),
            lambda: kb.sampled_matmul_batched_plain(seed, x, mu, sigma, S),
            lambda: unfused_fwd(seed, x, mu, sigma, S), KB_TAG)
        results["fwd"] = with_bound(
            f"K-B lanes S={S}",
            dict(max_abs_err=max(e for e, _ in errs), **times),
            4 * (S * BATCH * K + 2 * N * K + S * BATCH * N), 3 * flops,
            TF32_OPS, normals=S * N * K)

        S = TRAIN_MC
        g = torch.randn(S, BATCH, N, generator=gen, device="cuda")
        x = x[:S].contiguous()
        got = kb.sampled_matmul_dx_batched(seed, g, mu, sigma)
        err, scale = gate("K-D lanes", got,
                          kb.sampled_matmul_dx_batched_plain(seed, g, mu,
                                                             sigma))
        check(torch.equal(got[0], kb.sampled_matmul_dx(seed, g[0], mu,
                                                       sigma)),
              "K-D lanes: lane 0 differs from K-D")
        flops = 2 * S * BATCH * N * K
        log(f"[K-D lanes] S={S} M={BATCH} N={N} K={K} f32: max|kernel-plain|"
            f" = {err:.3e}, limit {1e-4 * scale:.3e}; lane 0 equal to K-D")
        times = sampled_times(
            f"K-D lanes S={S}",
            lambda: kb.sampled_matmul_dx_batched(seed, g, mu, sigma),
            lambda: kb.sampled_matmul_dx_batched_plain(seed, g, mu, sigma),
            lambda: unfused_dx(seed, g, mu, sigma), KD_TAG)
        results["dx"] = with_bound(
            f"K-D lanes S={S}", dict(max_abs_err=err, **times),
            4 * (S * BATCH * N + 2 * N * K + S * BATCH * K), 3 * flops,
            TF32_OPS, normals=S * N * K)

        errs, uerrs = [], []
        zeros, ones = torch.zeros_like(mu), torch.ones_like(mu)
        for what, xl in (("x per lane", x), ("x shared", x[0])):
            got = kb.sampled_matmul_dw_batched(seed, g, xl)
            want = kb.sampled_matmul_dw_batched_plain(seed, g, xl)
            e = [gate(f"K-E lanes ({what})", a, b) for a, b in zip(got, want)]
            errs.append(max(e))
            unf = unfused_dw(seed, g, xl, zeros, ones)
            uerrs.append(max(gate(f"K-E lanes' unfused route ({what})", a, b)
                             for a, b in zip(unf, want)))
        one = kb.sampled_matmul_dw_batched(seed, g[:1], x[0])
        check(all(torch.equal(a, b) for a, b in zip(
            one, kb.sampled_matmul_dw(seed, g[0], x[0]))),
            "K-E lanes: one lane differs from K-E")
        log(f"[K-E lanes] S={S} M={BATCH} N={N} K={K} f32: dmu, dsigma "
            f"summed over lanes: max|kernel-plain| = {errs[0][0]:.3e} (x per "
            f"lane), {errs[1][0]:.3e} (x shared); unfused route "
            f"{uerrs[0][0]:.3e}, {uerrs[1][0]:.3e}; one lane equal to K-E")
        times = sampled_times(
            f"K-E lanes S={S}",
            lambda: kb.sampled_matmul_dw_batched(seed, g, x),
            lambda: kb.sampled_matmul_dw_batched_plain(seed, g, x),
            lambda: unfused_dw(seed, g, x, zeros, ones), KE_TAG)
        results["dw"] = with_bound(
            f"K-E lanes S={S}",
            dict(max_abs_err=max(e for e, _ in errs), **times),
            4 * (S * BATCH * N + S * BATCH * K + 2 * N * K), 3 * flops,
            TF32_OPS, normals=S * N * K)
    return results


def kernel_counters():
    """{name: wrapper} of every kernel's launch counter."""
    from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb
    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka

    from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg
    from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kf

    return {"K-A": ka.sample_scaled_normals_batch, "K-B": kb.sampled_matmul,
            "K-C dsigma": ka.dsigma, "K-C drho": ka.drho,
            "K-D": kb.sampled_matmul_dx, "K-E": kb.sampled_matmul_dw,
            "K-F": kf.qmatmul_requant,
            "K-F flipout": kf.qmatmul_requant_flipout,
            "K-B lanes": kb.sampled_matmul_batched,
            "K-D lanes": kb.sampled_matmul_dx_batched,
            "K-E lanes": kb.sampled_matmul_dw_batched,
            "K-G": kg.mc_gemm, "K-G S=1": kg.pointwise_gemm,
            "K-G cl": kg.mc_gemm_cl, "K-G cl S=1": kg.pointwise_gemm_cl}


def sign_counters():
    """{name: wrapper} of the K-H kernels' launch counters, kept apart from
    ``kernel_counters``, whose counts the paths gate as a whole."""
    from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh

    return {"K-H1": kh.sign_flip, "K-H2": kh.sign_combine,
            "K-H3": kh.qsign_mul}


# the count of sign hashes run in torch on the card (``ops/sampling.py``
# ``_hashes.cuda_calls``), which every Flipout path holds at 0
TORCH_HASHES = "torch hashes on CUDA"


def reset_counts():
    from bayesian_torch_tpu_torch.ops.sampling import _hashes

    for fn in (*kernel_counters().values(), *sign_counters().values()):
        fn.launches = 0
    _hashes.cuda_calls = 0


def counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def sign_counts():
    """The K-H launches and the torch hashes on the card since the last
    ``reset_counts``."""
    from bayesian_torch_tpu_torch.ops.sampling import _hashes

    got = {name: fn.launches for name, fn in sign_counters().items()}
    got[TORCH_HASHES] = _hashes.cuda_calls
    return got


def expected_sign_launches(model, num_mc, vmap=False, training=False,
                           batches=1):
    """K-H launches of ``batches`` MC-``num_mc`` calls of a float Flipout
    model: per forward (one a draw through the loop, one for all lanes
    under the draw axis) K-H1 flips each Flipout layer's input and K-H2
    combines its output; a Flipout LSTM writes its four sign blocks with
    K-H1. A training step's backward adds a K-H1 for each combine and for
    each flip whose input carries a gradient: every layer's but the
    first's, whose input is the images. No sign is hashed in torch."""
    from bayesian_torch_tpu_torch.layers.rnn_base import _BaseLSTMLayer
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )

    flipout = [m for m in iter_bayesian_layers(model)
               if "Flipout" in type(m).__name__]
    lstms = sum(isinstance(m, _BaseLSTMLayer) for m in flipout)
    layers = len(flipout) - lstms
    forwards = batches * (1 if vmap else num_mc)
    flips = layers + 4 * lstms
    if training:
        flips += 2 * layers - 1
    return {"K-H1": forwards * flips, "K-H2": forwards * layers, "K-H3": 0,
            TORCH_HASHES: 0}


def check_signs(what, want):
    """The K-H launches and torch hashes since the last ``reset_counts``
    equal ``want``; returns them."""
    got = sign_counts()
    log(f"[{what}] sign launches {got}")
    check(got == want, f"{what}: sign launches {got}, want {want}")
    return got


def expected_step_launches(model, num_mc):
    """Kernel launches of one training step with draws in the layers: per
    draw, K-A once per in-layer draw (every weight not on the fused GEMM,
    every bias) and K-C (drho) for each in its backward; the fused-GEMM
    head's K-B forward and K-D, K-E backward once each."""
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )

    layers = list(iter_bayesian_layers(model))
    fused = sum(getattr(layer, "impl", "xla") == "pallas" for layer in layers)
    draws = sum((getattr(layer, "impl", "xla") != "pallas")
                + (layer.mu_bias is not None) for layer in layers)
    want = dict.fromkeys(kernel_counters(), 0)
    want.update({"K-A": num_mc * draws, "K-B": num_mc * fused,
                 "K-C drho": num_mc * draws, "K-D": num_mc * fused,
                 "K-E": num_mc * fused})
    return want


def expected_vmap_launches(model, training):
    """Kernel launches of one vmap-emission call with draws in the layers:
    K-A once per layer (weight and bias in one flat buffer), and once for
    the fused head's bias; K-B with lanes once per fused head. A training
    step adds K-C (dsigma) for every K-A launch and K-D, K-E with lanes
    once per fused head."""
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )

    layers = list(iter_bayesian_layers(model))
    fused = sum(getattr(layer, "impl", "xla") == "pallas" for layer in layers)
    draws = sum(getattr(layer, "impl", "xla") != "pallas"
                or layer.mu_bias is not None for layer in layers)
    want = dict.fromkeys(kernel_counters(), 0)
    want.update({"K-A": draws, "K-B lanes": fused})
    if training:
        want.update({"K-C dsigma": draws, "K-D lanes": fused,
                     "K-E lanes": fused})
    return want


def expected_remat_launches(model, num_mc, vmap):
    """Kernel launches of one training step of a ``remat_blocks`` model:
    the step's own (``expected_vmap_launches`` or
    ``expected_step_launches``), and K-A once more for each draw of a
    layer inside a residual block, which the recompute draws again (once
    under the draw axis, once per draw through the loop); the backward
    runs once."""
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )

    want = (expected_vmap_launches(model, training=True) if vmap
            else expected_step_launches(model, num_mc))
    inner = [layer for stage in (model.layer1, model.layer2, model.layer3,
                                 model.layer4)
             for layer in iter_bayesian_layers(stage)]
    if vmap:
        redraws = sum(getattr(layer, "impl", "xla") != "pallas"
                      or layer.mu_bias is not None for layer in inner)
    else:
        redraws = num_mc * sum((getattr(layer, "impl", "xla") != "pallas")
                               + (layer.mu_bias is not None)
                               for layer in inner)
    want["K-A"] += redraws
    return want


def labels(seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")


def bn_layers(model):
    from torch import nn

    return [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]


def check_grads(model, what):
    """Every gradient finite; no mu or rho gradient all zero."""
    import torch

    for name, p in model.named_parameters():
        check(p.grad is not None, f"{what}: {name} has no gradient")
        check(bool(torch.isfinite(p.grad).all()),
              f"{what}: non-finite gradient of {name}")
        if "mu_" in name or "rho_" in name:
            check(bool((p.grad != 0).any()),
                  f"{what}: gradient of {name} is all zero")


def phase_train(model):
    """The training main path: one warm-up and three timed MC-4 bs128
    ELBO steps. Returns the kernels' launches in the three timed steps."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step

    model.train()
    model.fc.impl = "pallas"
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(TRAIN_MC, BATCH, emission="scan")
    step(model, opt, images(SEED + 400), labels(SEED + 400))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = expected_step_launches(model, TRAIN_MC)
    bns = bn_layers(model)
    reset_counts()
    times = []
    for i in range(3):
        x, y = images(SEED + 401 + i), labels(SEED + 401 + i)
        tracked = [int(m.num_batches_tracked) for m in bns]
        running = [m.running_mean.clone() for m in bns]
        before = counts()
        t0 = time.perf_counter()
        loss, ce, kl = step(model, opt, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in counts().items()}
        log(f"[train] step {i}: {times[-1]:.1f} ms, "
            f"{BATCH / times[-1] * 1e3:.1f} images/s, loss {float(loss):.4f},"
            f" CE {float(ce):.4f}, KL {float(kl):.1f}, launches {got}")
        check(math.isfinite(float(loss)), f"step {i}: loss {float(loss)}")
        check_grads(model, f"step {i}")
        check(all(int(m.num_batches_tracked) == t + 1
                  for m, t in zip(bns, tracked)),
              f"step {i}: num_batches_tracked did not go up by exactly 1")
        check(all(not torch.equal(m.running_mean, r)
                  for m, r in zip(bns, running)),
              f"step {i}: a running mean did not move")
        check(got == want, f"step {i}: launches {got}, the model implies "
              f"{want}")
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] ResNet-50 MC-{TRAIN_MC} bs{BATCH} {IMAGE}^2 bf16, "
        f"fc.impl='pallas', presample 'auto' (off): median {ms:.1f} ms/step, "
        f"{BATCH / ms * 1e3:.1f} images/s, peak {peak:.2f} GiB; launches in "
        f"the three steps {counts()}")
    return counts()


def phase_train_presample(model):
    """One training step with presample="on": the whole model's draws in
    one K-A launch, their backward in one K-C (dsigma) launch."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step

    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(TRAIN_MC, BATCH, presample="on", emission="scan")
    x, y = images(SEED + 410), labels(SEED + 410)
    reset_counts()
    t0 = time.perf_counter()
    loss, _, _ = step(model, opt, x, y)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = counts()
    log(f"[train presample] presample='on': {ms:.1f} ms, loss "
        f"{float(loss):.4f}, launches {got}")
    check(math.isfinite(float(loss)), "presample step: loss")
    check_grads(model, "presample step")
    check(got["K-A"] == 1 and got["K-C dsigma"] == 1,
          f"presample step: K-A {got['K-A']} and K-C (dsigma) "
          f"{got['K-C dsigma']} launches, want 1 and 1")
    return got


def phase_train_sanity(model):
    """rho = -30 (sigma ~ 1e-13): every draw equals the posterior mean,
    so one MC-4 step and one MC-1 step from the same state give the same
    mu gradients and the same running statistics."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step

    saved = {k: v.clone() for k, v in model.state_dict().items()}
    x, y = images(SEED + 420), labels(SEED + 420)

    def step_from_saved(num_mc):
        model.load_state_dict(saved)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "rho" in name:
                    p.fill_(-30.0)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        make_train_step(num_mc, BATCH, emission="scan")(model, opt, x, y)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if "mu_" in n}
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return grads, stats

    try:
        g4, s4 = step_from_saved(TRAIN_MC)
        g1, s1 = step_from_saved(1)
    finally:
        model.load_state_dict(saved)
    worst = 0.0
    # bf16 activations; the two steps differ only in cuDNN's order of
    # accumulation and in how the two BN paths take the variance
    for what, a, b in (("mu gradient", g4, g1), ("running stat", s4, s1)):
        for k in b:
            diff, scale = max_err(a[k], b[k]), b[k].abs().max().item()
            check(diff <= 2**-6 * scale, f"rho=-30: {what} {k} differs "
                  f"between MC-{TRAIN_MC} and MC-1 ({diff:.3e} > 2^-6 x "
                  f"{scale:.3e})")
            worst = max(worst, diff / max(scale, 1e-30))
    log(f"[train sanity] rho=-30: MC-{TRAIN_MC} and MC-1 steps agree on "
        f"{len(g1)} mu gradients and {len(s1)} running statistics; worst "
        f"max|diff| / max|MC-1| = {worst:.3e}, limit 2^-6 = {2**-6:.3e}")


def phase_trainer():
    """The trainer entry point at full ResNet-50 width: train 2 epochs,
    resume to 3, test."""
    import io
    import os
    import tempfile

    from bayesian_torch_tpu_torch.examples import main_bayesian_imagenet

    def run(save_dir, *extra):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            metrics = main_bayesian_imagenet.main([
                "--synthetic", f"--batch-size={TRAINER_BATCH}",
                "--num_monte_carlo=2", f"--save_dir={save_dir}", *extra])
        text = out.getvalue()
        log(f"[trainer] {' '.join(extra)}: {time.perf_counter() - t0:.1f} s"
            f"; last lines: {' | '.join(text.strip().splitlines()[-2:])}")
        return metrics, text

    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        metrics, _ = run(tmp, "--mode=train", "--epochs=2")
        trained = counts()
        log(f"[trainer] launches in --epochs=2: {trained}")
        # one draw a step (--num_mc 1): emission="auto" keeps the draw loop
        check(trained["K-A"] > 1 and trained["K-C drho"] > 0,
              "the trainer's steps did not go through K-A and K-C (drho)")
        path = os.path.join(tmp, "imagenet_bayesian_metrics.json")
        with open(path) as f:
            saved = json.load(f)
        check(0.0 <= saved["accuracy"] <= 1.0, f"accuracy {saved}")
        _, text = run(tmp, "--mode=train", "--epochs=3", "--resume")
        check("resumed from epoch 2" in text and "epoch 2:" in text
              and "epoch 0:" not in text and "epoch 1:" not in text,
              "--resume did not start at epoch 2")
        tested, _ = run(tmp, "--mode=test")
        check(0.0 <= tested["accuracy"] <= 1.0, f"test accuracy {tested}")
    return trained


def profile_window(what, fn, rows=25):
    """Run ``fn`` once under torch.profiler; log wall time, device time,
    idle share and the top ``rows`` kernels; return {"wall": ms, "busy":
    ms, "events": the profiler's key averages}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = sum(e.self_device_time_total for e in events
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation) / 1e3
    # busy: the union of the device rows' spans (rows may overlap, so
    # their sum can exceed the wall time)
    busy, end = 0.0, -math.inf
    for start, stop in sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    busy /= 1e3
    log(f"[profile] {what}: wall {wall:.1f} ms under the profiler, device "
        f"rows {dev:.1f} ms, device busy {busy:.1f} ms (union of their "
        f"spans), idle share {1 - busy / wall:.3f}")
    log(events.table(sort_by="self_cuda_time_total", row_limit=rows,
                     max_name_column_width=70))
    return dict(wall=wall, busy=busy, events=events)


def phase_profile(model, x, kb):
    """One main-path batch under torch.profiler: host wall time, device
    time, the device's idle share and the kernels that take it; then the
    K-B kernel alone at the head shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bayesian_torch_tpu_torch.parallel import mc_forward

    profile_window("one inference main-path batch",
                   lambda: mc_forward(model, x, NUM_MC, reduce="mean"))

    mu = model.fc.mu_weight.detach()
    rho = model.fc.rho_weight.detach()
    xk = torch.randn(BATCH, mu.shape[1], device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            kb(4242, xk, mu, rho, out_dtype=torch.float32)
        torch.cuda.synchronize()
    (ev,) = [e for e in prof.key_averages()
             if KB_TAG in e.key]
    log(f"[profile] K-B kernel alone at M={BATCH} K={mu.shape[1]} "
        f"N={mu.shape[0]}: {ev.self_device_time_total / ev.count / 1e3:.4f} "
        f"ms of device time per launch, {ev.count} launches")


def phase_profile_train(model, emission="scan"):
    """One training main-path step under torch.profiler."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step

    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(TRAIN_MC, BATCH, emission=emission)
    x, y = images(SEED + 430), labels(SEED + 430)
    step(model, opt, x, y)  # warm-up outside the window
    profile_window(f"one training step (MC-{TRAIN_MC} bs{BATCH} bf16, "
                   f"emission={emission!r})", lambda: step(model, opt, x, y))


# --- helpers of the MC-10 inference paths ----------------------------------


@contextlib.contextmanager
def pointwise_dot():
    """``ops.conv.CONV_1X1_DOT = True`` inside; the default after."""
    from bayesian_torch_tpu_torch.ops import conv as conv_ops

    saved = conv_ops.CONV_1X1_DOT
    conv_ops.CONV_1X1_DOT = True
    try:
        yield
    finally:
        conv_ops.CONV_1X1_DOT = saved


def pointwise_sites(model):
    """The number of the model's convs that take the pointwise emission."""
    from bayesian_torch_tpu_torch.ops import conv as conv_ops

    return sum(
        conv_ops._is_pointwise(m.mu_kernel, m.stride, m.padding, m.dilation,
                               m.groups, True)
        for m in model.modules() if hasattr(m, "mu_kernel"))


def same_seeds(model, fn):
    """``fn()`` with the model's (shared) generator rewound after it."""
    gen = model.conv1.generator
    state = gen.get_state()
    try:
        return fn()
    finally:
        gen.set_state(state)


def timed_mc(what, model, batches, want, **kw):
    """Three MC-10 bs128 batches after a warm-up through
    ``mc_forward(model, x, 10, reduce="mean", **kw)``, every count set to 0
    before the first and every batch's launches equal to ``want``; returns
    (median ms, the launches of the three batches)."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    def run(x):
        out = mc_forward(model, x, NUM_MC, reduce="mean", **kw)
        return out[0] if isinstance(out, tuple) else out

    run(images(SEED + 100))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for i, x in enumerate(batches):
        before = counts()
        t0 = time.perf_counter()
        out = run(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in counts().items()}
        check(tuple(out.shape) == (BATCH, 1000), f"{what}: output shape "
              f"{tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
        check(got == want, f"{what} batch {i}: launches {got}, the model "
              f"implies {want}")
        log(f"[{what}] batch {i}: {times[-1]:.1f} ms, mean predictive "
            f"entropy {entropy(out):.4f} nats (max {math.log(1000):.4f})")
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{what}] ResNet-50 MC-{NUM_MC} bs{BATCH} {IMAGE}^2 bf16, "
        f"mc_forward({', '.join(f'{k}={v!r}' for k, v in kw.items())}): "
        f"median {ms:.1f} ms/batch, {BATCH / ms * 1e3:.1f} images/s "
        f"({BATCH * NUM_MC / ms * 1e3:.1f} image-draws/s), peak {peak:.2f} "
        f"GiB; launches per batch { {k: v for k, v in want.items() if v} }")
    return ms, counts()


def lanes_agree(what, model, x, dot=False):
    """The vmap emission lane for lane against the draw loop, or, with
    ``dot``, the vmap emission under the pointwise emission against the
    vmap emission on the default route: both under presample="on" with the
    layers' generator rewound, so both take the same presampled draws (and
    Flipout sign salts). bf16 activations: two conv routes round at other
    places, a few bf16 ulps of the largest logit at most."""
    from bayesian_torch_tpu_torch.parallel import mc_forward

    def run(emission, ctx):
        with ctx:
            return same_seeds(model, lambda: mc_forward(
                model, x, NUM_MC, presample="on", return_kl=False,
                emission=emission))

    a = run("vmap", pointwise_dot() if dot else contextlib.nullcontext())
    b = run("vmap" if dot else "scan", contextlib.nullcontext())
    check(tuple(a.shape) == tuple(b.shape) == (NUM_MC, BATCH, 1000),
          f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    diff, scale = max_err(a, b), b.float().abs().max().item()
    # each lane's largest difference in bf16 ulps of that lane's largest
    # logit: how many roundings apart the two routes end
    lane_diff = (a.float() - b.float()).abs().flatten(1).amax(1)
    ulps = lane_diff / bf16_ulp(b.float().abs().flatten(1).amax(1))
    log(f"[{what}] same presampled draws, {NUM_MC} lanes: max|diff| = "
        f"{diff:.3e}, limit 2^-6 x max|logit| = {scale * 2**-6:.3e}; per "
        f"lane in bf16 ulps of the lane's largest logit: "
        f"{', '.join(f'{u:.1f}' for u in ulps.tolist())}")
    check(diff <= scale * 2**-6, f"{what}: the two routes differ")


def mc_sanity(what, model, emission):
    """rho = -30: the MC-10 mean agrees with one draw."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    rhos = [p for n, p in model.named_parameters() if "rho" in n]
    saved = [p.detach().clone() for p in rhos]
    x = images(SEED + 1)
    with torch.no_grad():
        for p in rhos:
            p.fill_(-30.0)
    try:
        ten = mc_forward(model, x, NUM_MC, reduce="mean", return_kl=False,
                         emission=emission)
        one = mc_forward(model, x, 1, reduce="mean", return_kl=False)
    finally:
        with torch.no_grad():
            for p, v in zip(rhos, saved):
                p.copy_(v)
    diff, scale = max_err(ten, one), one.abs().max().item()
    log(f"[{what}] rho=-30, emission={emission!r}: max|MC-{NUM_MC} mean - "
        f"single draw| = {diff:.3e}, limit 2^-6 x max|logit| = "
        f"{scale * 2**-6:.3e}")
    check(diff <= scale * 2**-6, f"{what}: MC mean at sigma ~ 0 differs "
          "from a draw")


# --- the vmap emission --------------------------------------------------------


def phase_vmap_train(model, dot=False):
    """The vmap training path: one warm-up and three timed MC-4 bs128 ELBO
    steps; returns the kernels' launches in the three timed steps. With
    ``dot`` the same under the pointwise emission (``CONV_1X1_DOT = True``):
    every 1x1 stride-1 conv through K-G forward and, for its input
    gradient, K-G on the transposed weight."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step

    what = "pointwise vmap train" if dot else "vmap train"
    model.train()
    model.fc.impl = "pallas"
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(TRAIN_MC, BATCH, emission="vmap")
    ctx = pointwise_dot if dot else contextlib.nullcontext
    with ctx():
        step(model, opt, images(SEED + 440), labels(SEED + 440))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = expected_vmap_launches(model, training=True)
    if dot:
        want["K-G"] = 2 * pointwise_sites(model)
    bns = bn_layers(model)
    reset_counts()
    times = []
    for i in range(3):
        x, y = images(SEED + 441 + i), labels(SEED + 441 + i)
        tracked = [int(m.num_batches_tracked) for m in bns]
        running = [m.running_mean.clone() for m in bns]
        before = counts()
        t0 = time.perf_counter()
        with ctx():
            loss, ce, kl = step(model, opt, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in counts().items()}
        log(f"[{what}] step {i}: {times[-1]:.1f} ms, "
            f"{BATCH / times[-1] * 1e3:.1f} images/s, loss {float(loss):.4f},"
            f" CE {float(ce):.4f}, KL {float(kl):.1f}")
        check(math.isfinite(float(loss)),
              f"{what} step {i}: loss {float(loss)}")
        check_grads(model, f"{what} step {i}")
        check(all(int(m.num_batches_tracked) == t + 1
                  for m, t in zip(bns, tracked)),
              f"{what} step {i}: num_batches_tracked did not go up by 1")
        check(all(not torch.equal(m.running_mean, r)
                  for m, r in zip(bns, running)),
              f"{what} step {i}: a running mean did not move")
        check(got == want, f"{what} step {i}: launches {got}, the model "
              f"implies {want}")
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{what}] ResNet-50 MC-{TRAIN_MC} bs{BATCH} {IMAGE}^2 bf16, "
        f"emission='vmap', CONV_1X1_DOT={dot}, fc.impl='pallas', presample "
        f"'auto' (off): median "
        f"{ms:.1f} ms/step, {BATCH / ms * 1e3:.1f} images/s, peak "
        f"{peak:.2f} GiB; launches per step {want}")
    return counts()


def phase_vmap_train_sanity(model):
    """sigma ~ 0: a vmap MC-4 step and a loop MC-4 step from the same
    untrained state give the same mu gradients and running statistics,
    within 2^-6 of each tensor's largest value; a second loop step shows
    the spread of the loop against itself. A vmap step with the pointwise
    emission (``CONV_1X1_DOT = True``: every 1x1 stride-1 conv through K-G
    forward and K-G on the transposed weight backward, 2 x 33 launches)
    agrees with the vmap step on the default route within the same limit.
    In f32 with TF32 off and at
    rho = -60 (sigma ~ 1e-26): at rho = -30 (sigma ~ 1e-13) the draws
    still change this random network's f32 layer4 gradients by more than
    2^-6 from one loop step to the next, and in bf16 the roundings of the
    grouped and the plain convs do."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step

    model.train()
    model.fc.impl = "pallas"
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    dtypes = {m: m.compute_dtype for m in model.modules()
              if hasattr(m, "compute_dtype")}
    x, y = images(SEED + 450), labels(SEED + 450)

    def step_from_saved(emission, ctx=contextlib.nullcontext()):
        model.load_state_dict(saved)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "rho" in name:
                    p.fill_(-60.0)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        with ctx:
            make_train_step(TRAIN_MC, BATCH, emission=emission)(model, opt,
                                                                 x, y)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if "mu_" in n}
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return {**grads, **stats}, len(grads), len(stats)

    try:
        for m in dtypes:
            m.compute_dtype = None
        with tf32_off():
            vmap, _, _ = step_from_saved("vmap")
            loop, n_grads, n_stats = step_from_saved("scan")
            loop2, _, _ = step_from_saved("scan")
            reset_counts()
            dot, _, _ = step_from_saved("vmap", pointwise_dot())
            dot_launches = counts()["K-G"]
    finally:
        model.load_state_dict(saved)
        for m, dtype in dtypes.items():
            m.compute_dtype = dtype

    def worst(a, b):
        return max((max_err(a[k], b[k]) / max(b[k].abs().max().item(), 1e-30),
                    k) for k in b)

    err, name = worst(vmap, loop)
    spread, _ = worst(loop2, loop)
    log(f"[vmap train sanity] rho=-60, f32: vmap and loop MC-{TRAIN_MC} "
        f"steps on {n_grads} mu gradients and {n_stats} running statistics: "
        f"worst max|diff| / max|loop| = {err:.3e} ({name}), limit 2^-6 = "
        f"{2**-6:.3e}; two loop steps: {spread:.3e}")
    check(err <= 2**-6, f"rho=-60: {name} differs between the vmap and loop "
          f"MC-{TRAIN_MC} steps ({err:.3e} > 2^-6 of its largest value)")
    err, name = worst(dot, vmap)
    sites = pointwise_sites(model)
    log(f"[pointwise train sanity] rho=-60, f32: vmap MC-{TRAIN_MC} step with "
        f"CONV_1X1_DOT=True against the default route: worst max|diff| / "
        f"max|default| = {err:.3e} ({name}), limit 2^-6; {dot_launches} K-G "
        f"launches (forward and dx at {sites} sites)")
    check(err <= 2**-6, f"rho=-60: {name} differs between the pointwise and "
          f"the default vmap MC-{TRAIN_MC} steps ({err:.3e} > 2^-6)")
    check(dot_launches == 2 * sites, f"pointwise step: {dot_launches} K-G "
          f"launches, want {2 * sites} (forward and dx)")


# --- the INT8 post-training-quantization path --------------------------------


def int8_shapes(model, x):
    """{(M, K, N): launches} of K-F in one forward of a converted model:
    a conv is an (B*Ho*Wo, K) x (O, K) GEMM with K = C*kh*kw widened to a
    multiple of 16 as ``ops.int8.qconv`` builds its patches (the stem's 147
    to 160), the head a (B, in) x (out, in) one."""
    import collections

    from bayesian_torch_tpu_torch.layers.quantized_base import (
        _QuantizedLayerBase,
    )

    shapes = collections.Counter()

    def hook(mod, _, out):
        out = out[0] if isinstance(out, tuple) else out
        if mod.is_conv:
            o = out.shape
            k = mod.in_channels * math.prod(mod.kernel_size)
            shapes[(o[0] * math.prod(o[2:]), -(-k // 16) * 16,
                    mod.out_channels)] += 1
        else:
            shapes[(out.shape[0], mod.in_features, mod.out_features)] += 1

    layers = [m for m in model.modules() if isinstance(m, _QuantizedLayerBase)]
    handles = [m.register_forward_hook(hook) for m in layers]
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()
    check(sum(shapes.values()) == len(layers),
          f"{sum(shapes.values())} GEMMs for {len(layers)} quantized layers")
    return shapes


def phase_qmatmul(shapes):
    """K-F against its plain version at every GEMM shape of the INT8 main
    path and at ragged ones (M off the 128-row tile, N = 64, 65, 70 and
    1000, the stem's unwidened K = 147 and other K off 16), with x_zp = 128
    and no bias and with x_zp = 117 and a bias: bit for bit. Device times
    of the kernel, the plain version and ``torch._int_mm`` on the centred
    s8 operands (K, N padded to multiples of 8) at the path's shapes;
    summed over one forward's launches. ``torch._int_mm`` takes only more
    than 16 rows: at M <= 16 (the SCNN's linears at batch 1) no library
    call computes the same function, and its time is left out."""
    import torch
    import torch.nn.functional as F

    from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes=0.0, ops=0.0)
    no_library = []  # the shapes no library call computes
    worst = 0

    def operands(M, K, N):
        x = torch.randint(0, 256, (M, K), dtype=torch.uint8, device="cuda",
                          generator=gen)
        w = torch.randint(-128, 128, (N, K), dtype=torch.int8,
                          device="cuda", generator=gen)
        b = torch.randn(N, device="cuda", generator=gen)
        out_scale = 0.02 * 0.01 * 74 * 74 * K ** 0.5 / 40  # ~40 quanta
        for x_zp, bias in ((128, None), (117, b)):
            got = kf.qmatmul_requant(x, 0.02, x_zp, w, 0.01, bias, out_scale,
                                     128)
            args = kf.requant_args(w, x_zp, 0.02, 0.01, bias, out_scale)
            want = kf.qmatmul_requant_plain(x, w, *args, 128)
            err = (got.int() - want.int()).abs().max().item()
            check(err == 0, f"K-F differs from its plain version at M={M} "
                  f"K={K} N={N} x_zp={x_zp}: {err} quanta")
            del got, want
        return x, w, b, out_scale, args, err

    ragged = [(37, 147, 64), (1, 16, 1), (300, 100, 1000), (129, 576, 65),
              (250, 2048, 1000), (1000, 4608, 70),
              (BATCH * 112 * 112, 147, 64)]
    for M, K, N in ragged:
        worst = max(worst, operands(M, K, N)[-1])
    log(f"[K-F] ragged (M, K, N) {ragged}: bit-exact at x_zp 128 and "
        "117+bias")
    for (M, K, N), count in sorted(shapes.items()):
        x, w, b, out_scale, args, err = operands(M, K, N)
        worst = max(worst, err)
        kp, np_ = -(-K // 8) * 8, -(-N // 8) * 8
        xc = F.pad((x.int() - 128).to(torch.int8), (0, kp - K))
        wc = F.pad(w, (0, kp - K, 0, np_ - N))
        calls = [(lambda: kf.qmatmul_requant(x, 0.02, 117, w, 0.01, b,
                                             out_scale, 128), "qmatmul"),
                 (lambda: kf.qmatmul_requant_plain(x, w, *args, 128), None)]
        if M > 16:
            calls.append((lambda: torch._int_mm(xc, wc.t()), None))
        ms, plain_ms, *lib_ms = device_times(*calls)
        lib_ms = lib_ms[0] if lib_ms else None
        nbytes, ops = M * K + N * K + M * N + 8 * N, 2 * M * N * K
        bound_ms, by = bound(nbytes, ops, INT8_OPS)
        if lib_ms is None:
            no_library.append((M, K, N))
        lib = "n/a (M <= 16)" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"[K-F] M={M} K={K} N={N} x{count}: kernel {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TOP/s, {nbytes / ms / 1e6:.0f} GB/s), "
            f"plain {plain_ms:.4f} ms, torch._int_mm {lib}, bound "
            f"{bound_ms:.4f} ms ({by}); bit-exact at x_zp 128 and 117+bias")
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms or 0.0), ("bound_ms", bound_ms),
                       ("bytes", nbytes), ("ops", ops)):
            tot[key] += count * v
        del x, w, xc, wc
    if no_library:  # a sum over part of the forward is no library time
        tot["library_ms"] = None
    lib = (f"n/a ({len(no_library)} of {len(shapes)} shapes have M <= 16)"
           if no_library else f"{tot['library_ms']:.3f} ms")
    log(f"[K-F] one forward ({sum(shapes.values())} launches, "
        f"{len(shapes)} shapes): kernel {tot['ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, torch._int_mm {lib}, bound "
        f"{tot['bound_ms']:.3f} ms ({tot['ops'] / 1e12:.3f} T int8 "
        f"ops, {tot['bytes'] / 1e9:.3f} GB)")
    _, by = bound(tot["bytes"], tot["ops"], INT8_OPS)
    return dict(max_abs_err=float(worst), ms=tot["ms"],
                plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                bound_by=by, library_ms=tot["library_ms"])


def build_qresnet50(calibrate=None):
    import torch

    from bayesian_torch_tpu_torch.models.bayesian.\
        quantized_resnet_variational_large import qresnet50

    return qresnet50(generator=torch.Generator().manual_seed(SEED),
                     device="cuda", calibrate=calibrate, fuse_conv_bn=True,
                     quantize_activations=True)


def phase_int8_build(eval_x):
    """The calibrated INT8 model: the float ResNet-50 (f32) takes its BN
    statistics from one training-mode forward (observers off), gives two
    MC-10 predictive means on ``eval_x`` for the top-1 comparison, then
    calibrates on 3 batches of 32 images and is converted with conv+BN
    folding and uint8 activations."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    float_mean = {}

    def calibrate(model):
        prepared = [m for m in model.modules()
                    if getattr(m, "quant_prepare", False)]
        for m in prepared:
            m.quant_prepare = False
        set_bn_statistics(model, images(SEED + 500))
        # two independent f32 MC-10 means: how far apart two float
        # predictions already are sets the scale of the int8 comparison
        float_mean["means"] = [mc_forward(model, eval_x, NUM_MC,
                                          reduce="mean", return_kl=False)
                               for _ in range(2)]
        for m in prepared:
            m.quant_prepare = True
        with torch.no_grad():
            for i in range(3):
                model(images(SEED + 510 + i)[:CALIB_BATCH])

    t0 = time.perf_counter()
    model = build_qresnet50(calibrate)
    torch.cuda.synchronize()
    layers = [m for m in model.modules() if hasattr(m, "quant_dict")]
    check(len(layers) == INT8_LAYERS and all(m.quant_dict is not None
                                             for m in layers),
          "not every layer of the converted model is calibrated")
    log(f"[int8 build] qresnet50 f32 -> BN statistics, float MC-{NUM_MC} "
        f"mean, 3 x {CALIB_BATCH} calibration images, convert(fuse_conv_bn"
        f"=True, quantize_activations=True): {time.perf_counter() - t0:.1f} "
        f"s; {len(layers)} quantized layers")
    return model, float_mean["means"]


def timed_batches(what, fn, batches, launches_each, flipout_each=0):
    """Median ms of ``fn(x)`` over ``batches`` after one warm-up, every
    count set to 0 before the first and K-F's checked per batch (plain:
    ``launches_each``; with the Flipout epilogue: ``flipout_each``);
    returns (median ms, outputs, plain K-F launches)."""
    import torch

    fn(images(SEED + 600))
    torch.cuda.synchronize()
    reset_counts()
    times, outs = [], []
    for i, x in enumerate(batches):
        before = counts()
        t0 = time.perf_counter()
        out = fn(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = {k: counts()[k] - before[k] for k in ("K-F", "K-F flipout")}
        want = {"K-F": launches_each, "K-F flipout": flipout_each}
        check(tuple(out.shape) == (BATCH, 1000)
              and bool(torch.isfinite(out).all()), f"{what}: output")
        check(got == want, f"{what}: K-F launched {got} in batch {i}, want "
              f"{want}")
        outs.append(out)
    ms = statistics.median(times)
    launches = counts()["K-F"]
    log(f"[{what}] batches {', '.join(f'{t:.1f}' for t in times)} ms; "
        f"median {ms:.1f} ms/batch, {BATCH / ms * 1e3:.1f} images/s, K-F "
        f"launches {launches}, with the Flipout epilogue "
        f"{counts()['K-F flipout']}")
    return ms, outs, launches


def phase_int8_main(model, batches, float_means):
    """The INT8 main path: MC-10 at batch 128 (every K-F launch counted
    from zero), then the weight build alone, then frozen-draw MC-1."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    def mc10(x):
        return mc_forward(model, x, NUM_MC, reduce="mean", return_kl=False)

    torch.cuda.reset_peak_memory_stats()
    ms, outs, launches = timed_batches(
        f"int8 main MC-{NUM_MC} bs{BATCH}", mc10, batches,
        INT8_LAYERS * NUM_MC)
    peak = torch.cuda.max_memory_allocated() / 2**30
    def agree(a, b):
        return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    f0, f1 = float_means
    log(f"[int8 main] peak {peak:.2f} GiB; top-1 agreement on batch 0 "
        f"(reported, not gated) of the int8 and an f32 MC-{NUM_MC} "
        f"predictive mean: {agree(outs[0], f0):.4f}; of two f32 MC-{NUM_MC} "
        f"means: {agree(f0, f1):.4f}; predictive entropy int8 "
        f"{entropy(outs[0]):.4f}, f32 {entropy(f0):.4f}")

    layers = [m for m in model.modules() if hasattr(m, "quant_dict")]
    build_ms = []
    for _ in range(3):
        build_ms.append(cuda_ms(lambda: [m._sampled_qweight_reparam(6 / 255)
                                         for m in layers]))
    log(f"[int8 weight build] all {len(layers)} layers' int8 weights for one "
        f"draw (eps, quantize, qmul, qadd in torch): median "
        f"{statistics.median(build_ms):.2f} ms of {build_ms}")
    return ms, launches


def phase_int8_frozen(model, batches):
    """Frozen-draw serving, MC-1 (``freeze_quantized_draws``)."""
    from bayesian_torch_tpu_torch.quantization import freeze_quantized_draws

    import torch

    n = freeze_quantized_draws(model)
    check(n == INT8_LAYERS, f"froze {n} layers")
    with torch.no_grad():
        ms, _, _ = timed_batches("int8 frozen MC-1", lambda x: model(x)[0],
                                 batches, INT8_LAYERS)
    return ms


def phase_int8_sanity(model, x):
    """With frozen draws the card's logits on 2 images equal a CPU copy's
    (the plain versions): the activations into the average pool bit for
    bit (integer GEMMs, the same f32 epilogues and adds), the logits
    within 3 head-output quanta (the pool's f32 sums run in another order
    on the CPU, which can move a head input across a rounding boundary).
    Then two unfrozen MC-1 forwards must differ."""
    import torch

    from bayesian_torch_tpu_torch.models.bayesian.\
        quantized_resnet_variational_large import qresnet50
    from bayesian_torch_tpu_torch.ops.qtensor import dequantize_if_qtensor
    from bayesian_torch_tpu_torch.quantization import (
        unfreeze_quantized_draws,
    )
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state

    t0 = time.perf_counter()
    cpu = qresnet50(generator=torch.Generator().manual_seed(SEED + 1),
                    fuse_conv_bn=True, quantize_activations=True)
    load_jax_quant_state(
        cpu, {k: v.cpu().numpy() for k, v in model.state_dict().items()},
        {name: m.quant_dict for name, m in model.named_modules()
         if hasattr(m, "quant_dict")})
    pooled = {}

    def run(m, xs):
        h = m.avgpool.register_forward_hook(
            lambda mod, inp, out: pooled.__setitem__(
                xs.device.type, dequantize_if_qtensor(inp[0]).cpu()))
        try:
            with torch.no_grad():
                return m(xs)[0].cpu()
        finally:
            h.remove()

    xs = x[:2]
    got, want = run(model, xs), run(cpu, xs.cpu())
    head_q = model.fc.quant_dict[4]["scale"]
    diff = (got - want).abs()
    exact = torch.equal(pooled["cuda"], pooled["cpu"])
    log(f"[int8 sanity] card vs CPU copy, frozen draws, 2 images "
        f"({time.perf_counter() - t0:.1f} s): activations into the pool "
        f"equal: {exact}; logits max|diff| {diff.max().item():.3e} = "
        f"{diff.max().item() / head_q:.2f} head quanta (limit 3), "
        f"{(diff == 0).float().mean().item():.4f} of them equal")
    check(exact, "card and CPU activations into the pool differ")
    check(diff.max().item() <= 3 * head_q * (1 + 1e-6),
          "card and CPU logits differ by more than 3 head quanta")
    unfreeze_quantized_draws(model)
    with torch.no_grad():
        a, b = model(x)[0], model(x)[0]
    check(not torch.equal(a, b), "two unfrozen MC-1 forwards are equal")
    log("[int8 sanity] two unfrozen MC-1 forwards differ")


def phase_int8_uncalibrated(batches):
    """The JAX bench's configuration: no calibration, every tensor at
    scale 0.2 and zero point 128; MC-1 per-forward redraw."""
    import torch


    model = build_qresnet50()
    check(all(m.quant_dict is None for m in model.modules()
              if hasattr(m, "quant_dict")), "uncalibrated model has scales")
    with torch.no_grad():
        ms, _, _ = timed_batches("int8 uncalibrated MC-1",
                                 lambda x: model(x)[0], batches, INT8_LAYERS)
    return ms



# --- K-G, the pointwise emission and Flipout ---------------------------------


def bf16_ulp_of_max(want):
    """One bf16 ulp of the largest |value| of ``want``."""
    return bf16_ulp(want.float().abs().max()).item()


def kg_gate(what, got, want):
    """K-G against its plain version: int8 bit for bit; f32 within 1e-4 x
    max|plain| (order of summation); bf16 within one bf16 ulp of the
    largest value (both round one f32 sum). Returns the error."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {tuple(got.shape)} {got.dtype} against "
          f"{tuple(want.shape)} {want.dtype}")
    if got.dtype == torch.int32:
        err = (got.long() - want.long()).abs().max().item()
        limit = 0
    else:
        err = max_err(got, want)
        limit = (1e-4 * want.abs().max().item()
                 if got.dtype == torch.float32 else bf16_ulp_of_max(want))
    check(err <= limit, f"{what} differs from its plain version "
          f"({err:.3e} > {limit:.3e})")
    return float(err), float(limit)


def phase_mc_gemm():
    """K-G against its plain version at the 12 pointwise sites of
    ResNet-50 (S = 10, B = 128, bf16), beside the S-way grouped cuDNN conv
    of the default route and ``torch.matmul`` with the broadcast weight;
    then the shared-input and shared-weight cases and a ragged case.
    At each site the S = 1 wrapper is held the same way at the shape the
    Flipout vmap run gives it (the mean conv: one weight over the B*S
    batch). K-G's backward at each site: the input gradient dx = w^T g is
    K-G on the transposed weight (S, C, O), held against its plain version
    and timed beside ``torch.matmul``, and one autograd pass through
    ``mc_gemm`` launches K-G twice and gives that dx. Returns three
    kernels-line entries, K-G's, the S = 1 wrapper's and the backward's:
    sums over one forward's (or backward's) 33 sites."""
    import torch

    from bayesian_torch_tpu_torch.ops import conv as conv_ops
    from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    S = NUM_MC
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, cudnn_ms=0.0,
               bound_ms=0.0, bytes=0.0, ops=0.0)
    one = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bwd = dict(one)
    worst = worst_one = worst_dx = 0.0
    for ci, co, sp, count in POINTWISE_SITES:
        x = rand(BATCH, S * ci, sp, sp)
        w = rand(S, co, ci, 1, 1)
        x4, w3 = x.reshape(BATCH, S, ci, sp * sp), w.reshape(S, co, ci)
        got, want = kg.mc_gemm(x4, w3), kg.mc_gemm_plain(x4, w3)
        err, limit = kg_gate(f"K-G at {ci}->{co}@{sp}", got, want)
        worst = max(worst, err)
        via_conv = conv_ops.conv_draws(x, w, pointwise_dot=True)
        check(torch.equal(via_conv.reshape(got.shape), got),
              "conv_draws(pointwise_dot=True) is not K-G's output")
        del got, want, via_conv
        ms, plain_ms, cudnn_ms, lib_ms = device_times(
            (lambda: kg.mc_gemm(x4, w3), "mc_gemm"),
            (lambda: kg.mc_gemm_plain(x4, w3), None),
            (lambda: conv_ops.conv_draws(x, w), None),
            (lambda: torch.matmul(w3, x4), None))
        nbytes = 2 * (x.numel() + w.numel() + BATCH * S * co * sp * sp)
        ops = 2 * BATCH * S * co * sp * sp * ci
        bound_ms, by = bound(nbytes, ops, BF16_OPS)
        log(f"[K-G] {ci}->{co}@{sp} x{count}: max|kernel-plain| {err:.3e} "
            f"(limit {limit:.3e}, one bf16 ulp of the largest value); "
            f"kernel {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
            f"{ops / ms / 1e9:.1f} TFLOP/s), grouped cuDNN conv "
            f"{cudnn_ms:.3f} ms, torch.matmul {lib_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({by})")
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("cudnn_ms", cudnn_ms),
                       ("bound_ms", bound_ms), ("bytes", nbytes),
                       ("ops", ops)):
            tot[key] += count * v
        # the S = 1 wrapper on the same bytes: (B*S, C, P) under one weight
        xs, w0 = x.reshape(BATCH * S, ci, sp * sp), w3[0]
        got, want = kg.pointwise_gemm(xs, w0), kg.mc_gemm_plain(xs, w0)[:, 0]
        err, limit = kg_gate(f"K-G S=1 at {ci}->{co}@{sp}", got, want)
        worst_one = max(worst_one, err)
        via_conv = conv_ops.conv_nd(xs.reshape(BATCH * S, ci, sp, sp), w[0],
                                    pointwise_dot=True)
        check(torch.equal(via_conv.reshape(got.shape), got),
              "conv_nd(pointwise_dot=True) is not K-G's output")
        del got, want, via_conv
        ms, plain_ms, lib_ms = device_times(
            (lambda: kg.pointwise_gemm(xs, w0), "mc_gemm"),
            (lambda: kg.mc_gemm_plain(xs, w0), None),
            (lambda: torch.matmul(w0, xs), None))
        nbytes -= 2 * (S - 1) * w0.numel()  # the weight is read once
        bound_ms, by = bound(nbytes, ops, BF16_OPS)
        log(f"[K-G S=1] {ci}->{co}@{sp} x{count}, batch {BATCH * S}: "
            f"max|kernel-plain| {err:.3e} (limit {limit:.3e}); kernel "
            f"{ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
            f"{ops / ms / 1e9:.1f} TFLOP/s), torch.matmul {lib_ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({by})")
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound_ms)):
            one[key] += count * v
        del xs, w0
        # the backward: dx through K-G on the transposed weight
        g = rand(BATCH, S, co, sp * sp)
        wt = w3.transpose(1, 2).contiguous()
        want = kg.mc_gemm_plain(g, wt)
        err, limit = kg_gate(f"K-G dx at {ci}->{co}@{sp}", kg.mc_gemm(g, wt),
                             want)
        worst_dx = max(worst_dx, err)
        xg = x4.clone().requires_grad_(True)
        wg = w3.clone().requires_grad_(True)
        before = kg.mc_gemm.launches
        kg.mc_gemm(xg, wg).backward(g)
        check(kg.mc_gemm.launches == before + 2, "autograd through mc_gemm: "
              f"{kg.mc_gemm.launches - before} K-G launches, want 2")
        kg_gate(f"K-G autograd dx at {ci}->{co}@{sp}", xg.grad, want)
        del want, xg, wg
        ms, plain_ms, lib_ms = device_times(
            (lambda: kg.mc_gemm(g, wt), "mc_gemm"),
            (lambda: kg.mc_gemm_plain(g, wt), None),
            (lambda: torch.matmul(wt, g), None))
        nbytes = 2 * (g.numel() + wt.numel() + x4.numel())
        bound_ms, by = bound(nbytes, ops, BF16_OPS)
        log(f"[K-G dx] {co}->{ci}@{sp} x{count}: max|kernel-plain| {err:.3e} "
            f"(limit {limit:.3e}); kernel {ms:.3f} ms ({nbytes / ms / 1e6:.0f}"
            f" GB/s, {ops / ms / 1e9:.1f} TFLOP/s), torch.matmul {lib_ms:.3f}"
            f" ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({by})")
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound_ms)):
            bwd[key] += count * v
        del x, w, x4, w3, g, wt
    log(f"[K-G] one MC-{S} bs{BATCH} forward ({N_POINTWISE} sites, "
        f"{len(POINTWISE_SITES)} shapes, bf16): kernel {tot['ms']:.2f} ms, "
        f"grouped cuDNN conv {tot['cudnn_ms']:.2f} ms, torch.matmul "
        f"{tot['library_ms']:.2f} ms, plain {tot['plain_ms']:.2f} ms, bound "
        f"{tot['bound_ms']:.2f} ms ({tot['ops'] / 1e12:.3f} TFLOP, "
        f"{tot['bytes'] / 1e9:.2f} GB)")
    log(f"[K-G S=1] the same {N_POINTWISE} sites under one weight (batch "
        f"{BATCH * S}): kernel {one['ms']:.2f} ms, torch.matmul "
        f"{one['library_ms']:.2f} ms, plain {one['plain_ms']:.2f} ms, bound "
        f"{one['bound_ms']:.2f} ms")
    log(f"[K-G dx] one MC-{S} bs{BATCH} backward's {N_POINTWISE} input "
        f"gradients: kernel {bwd['ms']:.2f} ms, torch.matmul "
        f"{bwd['library_ms']:.2f} ms, plain {bwd['plain_ms']:.2f} ms, bound "
        f"{bwd['bound_ms']:.2f} ms")

    def with_bias(what, fn, x, w, b):
        """The product within kg_gate's limit of its plain version, and
        with the bias bit for bit that product plus the bias in the output
        type (the epilogue: one cast, one add, one rounding)."""
        got = fn(x, w)
        err, _ = kg_gate(what, got, kg.mc_gemm_plain(x, w).reshape(got.shape))
        bias = b.reshape((1, *b.shape, 1)).float()
        want = (got.float() + bias).to(got.dtype)
        check(torch.equal(fn(x, w, b), want), f"{what}: with the bias, not "
              f"the kernel's product plus the bias in {got.dtype}")
        return err

    # shared input (the stem-side case), shared weight, both with a bias,
    # where x comes by TMA (56x56) and where it comes in slabs (14x14,
    # 7x7); and ragged shapes with a bias: 7x7 rows of 98 bytes, C and O
    # off the tiles (C = 33: the register gather)
    e_in = e_w = 0.0
    for ci, co, sp in ((256, 64, 56), (1024, 256, 14), (2048, 512, 7)):
        x = rand(BATCH, ci, sp * sp)
        w, b = rand(S, co, ci), rand(S, co)
        e_in = max(e_in, with_bias(f"K-G, shared input {ci}->{co}@{sp}",
                                   kg.mc_gemm, x, w, b))
        e_w = max(e_w, with_bias(f"K-G, shared weight {ci}->{co}@{sp}",
                                 kg.pointwise_gemm, x, w[0], b[0]))
        del x, w, b
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        x = rand(3, S, 33, 49, dtype=dtype)
        w, b = rand(S, 70, 33, dtype=dtype), rand(S, 70, dtype=dtype)
        with tf32_off():
            errs.append(with_bias(f"K-G, ragged {dtype}", kg.mc_gemm, x, w,
                                  b))
    log(f"[K-G] shared input {e_in:.3e}, shared weight {e_w:.3e} (256->64@56"
        f", 1024->256@14, 2048->512@7); ragged B=3 S={S} O=70 C=33 P=49: "
        f"bf16 {errs[0]:.3e}, f32 {errs[1]:.3e}: all within their limits, "
        "and with a bias each equal to its product plus the bias")
    _, by = bound(tot["bytes"], tot["ops"], BF16_OPS)
    return (dict(max_abs_err=worst, ms=tot["ms"], plain_ms=tot["plain_ms"],
                 bound_ms=tot["bound_ms"], bound_by=by,
                 library_ms=tot["library_ms"]),
            dict(max_abs_err=max(worst_one, e_w), bound_by=by, **one),
            dict(max_abs_err=worst_dx, bound_by=by, **bwd))


def phase_matmul_probe():
    """K-G at S = 1, B = 1 at the matmul probe's shapes, bf16 -> bf16 and
    s8 -> s32, beside ``torch.matmul`` and ``torch._int_mm``. Returns
    the measured sums over the four cases, for the S = 1 kernels-line entry
    to carry beside its sums at the main path's shapes (their bound's sum
    goes to the log)."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    worst = 0.0
    for M, K, N in ((4096, 4096, 4096), (8192, 4096, 4096)):
        for dtype in (torch.bfloat16, torch.int8):
            if dtype == torch.int8:
                a = torch.randint(-127, 127, (M, K), dtype=dtype,
                                  device="cuda", generator=gen)
                b = torch.randint(-127, 127, (K, N), dtype=dtype,
                                  device="cuda", generator=gen)
                library, peak, out_size = torch._int_mm, INT8_OPS, 4
            else:
                a = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
                b = torch.randn(K, N, device="cuda", generator=gen).to(dtype)
                library, peak, out_size = torch.matmul, BF16_OPS, 2
            plain = lambda: kg.mc_gemm_plain(b[None], a)[0, 0]  # noqa: E731
            err, limit = kg_gate(f"K-G matmul {M}x{K}x{N} {dtype}",
                                 kg.matmul(a, b), plain())
            worst = max(worst, err)
            ms, plain_ms, lib_ms = device_times(
                (lambda: kg.matmul(a, b), "mc_gemm"), (plain, None),
                (lambda: library(a, b), None))
            ops = 2 * M * N * K
            nbytes = a.element_size() * (M * K + K * N) + out_size * M * N
            bound_ms, by = bound(nbytes, ops, peak)
            log(f"[K-G S=1] ({M}, {K}) @ ({K}, {N}) {dtype}: max|kernel-"
                f"plain| {err:.3e} (limit {limit:.3e}); kernel {ms:.3f} ms "
                f"({ops / ms / 1e9:.1f} T/s), {library.__name__} "
                f"{lib_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({by})")
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bound_ms", bound_ms)):
                tot[key] += v
            del a, b
    log(f"[K-G S=1] the probe's four cases: bound {tot.pop('bound_ms'):.3f} "
        "ms in all (operations)")
    return dict(probe_max_abs_err=worst,
                **{"probe_" + key: v for key, v in tot.items()})


def phase_pointwise_vmap(model, batches, default_ms):
    """The reparameterization vmap MC-10 run again with the pointwise
    emission: every 1x1 stride-1 conv through K-G."""
    sites = pointwise_sites(model)
    check(sites == N_POINTWISE, f"{sites} pointwise convs, want "
          f"{N_POINTWISE}")
    model.fc.impl = "pallas"
    want = expected_vmap_launches(model, training=False)
    want["K-G"] = sites
    with pointwise_dot():
        ms, launches = timed_mc("pointwise vmap", model, batches, want,
                                return_kl=False, emission="vmap")
    lanes_agree("pointwise vmap vs default", model, batches[0], dot=True)
    log(f"[pointwise vmap] CONV_1X1_DOT=True {ms:.1f} ms/batch against "
        f"{default_ms:.1f} ms/batch on the default (grouped cuDNN) route; "
        f"{sites} K-G launches per forward")
    return launches


def phase_flipout_inference(model, batches, profile):
    """Flipout ResNet-50 MC-10 bs128 bf16 inference: the loop (one K-A
    launch per batch: every layer's perturbations drawn first), the vmap
    emission (one K-A launch per layer), lane for lane, the rho = -30
    check, and one vmap batch with the pointwise emission. Returns the
    launches of that last batch."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    none = dict.fromkeys(kernel_counters(), 0)
    res = {}
    res["loop_ms"], _ = timed_mc("flipout loop", model, batches,
                                 dict(none, **{"K-A": 1}))
    res["loop_signs"] = check_signs("flipout loop", expected_sign_launches(
        model, NUM_MC, batches=len(batches)))
    res["vmap_ms"], _ = timed_mc(
        "flipout vmap", model, batches,
        expected_vmap_launches(model, training=False), return_kl=False,
        emission="vmap")
    res["vmap_signs"] = check_signs("flipout vmap", expected_sign_launches(
        model, NUM_MC, vmap=True, batches=len(batches)))
    lanes_agree("flipout vmap vs loop", model, batches[0])
    mc_sanity("flipout sanity", model, "auto")
    mc_sanity("flipout sanity", model, "vmap")
    sites = pointwise_sites(model)
    reset_counts()
    lanes_agree("flipout pointwise vmap vs default", model, batches[0],
                dot=True)
    got = counts()
    # the mean conv of a site is one product at S = 1 over the B * S
    # batch, its perturbation conv the per-draw product
    check(got["K-G"] == sites and got["K-G S=1"] == sites,
          f"Flipout vmap with CONV_1X1_DOT: K-G {got['K-G']} and K-G S=1 "
          f"{got['K-G S=1']} launches, want {sites} each")
    with pointwise_dot():
        ms = median_ms(lambda: mc_forward(
            model, batches[0], NUM_MC, reduce="mean", return_kl=False,
            emission="vmap"), reps=3)
    log(f"[flipout pointwise vmap] CONV_1X1_DOT=True: {ms:.1f} ms/batch "
        f"(device time), {sites} K-G and {sites} K-G S=1 launches per "
        "forward")
    if profile:
        profile_window(f"one Flipout loop inference batch (MC-{NUM_MC} "
                       f"bs{BATCH})", lambda: mc_forward(
                           model, batches[0], NUM_MC, reduce="mean",
                           return_kl=False))
        profile_window(f"one Flipout vmap inference batch (MC-{NUM_MC} "
                       f"bs{BATCH})", lambda: mc_forward(
                           model, batches[0], NUM_MC, reduce="mean",
                           return_kl=False, emission="vmap"))
    torch.cuda.empty_cache()
    return got, res


def phase_flipout_train(model, emission, profile):
    """Flipout MC-4 bs128 bf16 ELBO steps through ``make_train_step``: one
    warm-up and three timed steps; finite, non-zero gradients on every mu
    and rho; launches per step equal to what the model implies (the loop:
    K-A at S = 1 on a zero mean for every perturbation, and K-C (drho)
    behind it; vmap: one K-A and one K-C (dsigma) per layer)."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step

    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(TRAIN_MC, BATCH, emission=emission)
    step(model, opt, images(SEED + 460), labels(SEED + 460))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = (expected_vmap_launches(model, training=True)
            if emission == "vmap"
            else expected_step_launches(model, TRAIN_MC))
    bns = bn_layers(model)
    reset_counts()
    times = []
    for i in range(3):
        x, y = images(SEED + 461 + i), labels(SEED + 461 + i)
        tracked = [int(m.num_batches_tracked) for m in bns]
        before = counts()
        t0 = time.perf_counter()
        loss, ce, kl = step(model, opt, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in counts().items()}
        log(f"[flipout train {emission}] step {i}: {times[-1]:.1f} ms, loss "
            f"{float(loss):.4f}, CE {float(ce):.4f}, KL {float(kl):.1f}")
        check(math.isfinite(float(loss)), f"flipout step {i}: loss")
        check_grads(model, f"flipout {emission} step {i}")
        check(all(int(m.num_batches_tracked) == t + 1
                  for m, t in zip(bns, tracked)),
              f"flipout step {i}: num_batches_tracked did not go up by 1")
        check(got == want, f"flipout {emission} step {i}: launches {got}, "
              f"the model implies {want}")
    check_signs(f"flipout train {emission}", expected_sign_launches(
        model, TRAIN_MC, vmap=emission == "vmap", training=True, batches=3))
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[flipout train {emission}] Flipout ResNet-50 MC-{TRAIN_MC} "
        f"bs{BATCH} {IMAGE}^2 bf16, emission={emission!r}: median {ms:.1f} "
        f"ms/step, {BATCH / ms * 1e3:.1f} images/s, peak {peak:.2f} GiB; "
        f"launches per step { {k: v for k, v in want.items() if v} }")
    if profile:
        x, y = images(SEED + 470), labels(SEED + 470)
        profile_window(f"one Flipout training step (MC-{TRAIN_MC} bs{BATCH} "
                       f"bf16, emission={emission!r})",
                       lambda: step(model, opt, x, y))
    opt.zero_grad(set_to_none=True)
    model.eval()
    torch.cuda.empty_cache()
    return counts()


def phase_flipout(profile):
    """Build Flipout ResNet-50 (bf16 compute, BN statistics from one
    batch) and drive its inference and training paths."""
    import torch

    from bayesian_torch_tpu_torch.models.bayesian.resnet_flipout_large \
        import resnet50

    model = resnet50(num_classes=1000,
                     generator=torch.Generator().manual_seed(SEED + 2),
                     device="cuda")
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.bfloat16
    set_bn_statistics(model, images(SEED + 200))
    batches = [images(SEED + 1 + i) for i in range(3)]
    dot, res = phase_flipout_inference(model, batches, profile)
    del batches
    torch.cuda.empty_cache()
    loop = phase_flipout_train(model, "scan", profile)
    vmap = phase_flipout_train(model, "vmap", profile)
    return dot, loop, vmap, res


# --- phase 46: K-H, the Flipout signs inside their products -----------------


def phase_signs():
    """(46) K-H at full width against its plain versions, bit for bit: (a)
    K-H1 (x * signs) and K-H2 (mean + pert * signs) at the 54 layers'
    activations of ResNet-50 MC-10 bs128, bf16, under the draw axis (lanes
    on dim 1; the stem's input shared across them) and in the draw loop's
    form (one salt, no lane dim, each layer's (128, C, H, W) input and
    output); (b) one layer in f32, both forms;
    (c) the mesh forms: a rank's rows under ``data=2`` (64 of 128, phase
    43), a tensor-parallel shard's output channels under ``model=2`` at
    MC-2 bs8 (phase 45), NCHW and NHWC, and the LSTM's sign blocks of a
    rank under ``mc=2`` and ``data=2`` at config #4 (K-H1 writing the
    signs); (d) K-H3 at the 108 uint8 sign products of one INT8 Flipout
    forward at bs128, calibrated and default scales; (d') the INT8 Flipout
    layers' fused forms at the 54 layers (``int8_fused_checks``); (e) the
    device time of one MC-10 batch's sign work through the draw loop
    (``kernel_times.sign_work``: 540 flips, 540 combines, 1,080 INT8
    products, 540 input passes) and of one forward's 54 perturbation GEMMs
    with K-F's Flipout epilogue beside the plain versions' (CUDA events),
    the route before the epilogue and the bound. Returns {kernel: its
    kernels-line numbers}."""
    import torch

    from bayesian_torch_tpu_torch.ops import sampling as ts
    from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh

    t0 = time.perf_counter()
    errs = {"K-H1": 0.0, "K-H2": 0.0, "K-H3": 0.0, "K-F flipout": 0.0}
    checked = dict.fromkeys(errs, 0)

    def same(name, what, got, want):
        err = max_err(got, want)
        errs[name] = max(errs[name], err)
        checked[name] += 1
        check(got.dtype == want.dtype and got.shape == want.shape
              and torch.equal(got, want),
              f"{name} {what}: differs from its plain version (max |diff| "
              f"{err})")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1100)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def flip_and_combine(what, si, so, lanes, shared=False,
                         dtype=torch.bfloat16, **block_kw):
        salts = [ts.sign_salts(SEED + 1101, s) for s in range(lanes)]
        axis = block_kw.pop("axis", 1)
        bi = ts.sign_block([a for a, _ in salts], si, axis=axis)
        full = bi.lanes_shape
        x = randn(full[:axis] + (1,) + full[axis + 1:] if shared else full,
                  dtype)
        same("K-H1", f"{what} input {full}", kh.sign_flip(x, bi),
             kh.sign_flip_plain(x, bi))
        del x
        bo = ts.sign_block([b for _, b in salts], so, axis=axis,
                           output=True)
        mean, pert = randn(bo.lanes_shape, dtype), randn(bo.lanes_shape,
                                                          dtype)
        same("K-H2", f"{what} output {bo.lanes_shape}",
             kh.sign_combine(mean, pert, bo),
             kh.sign_combine_plain(mean, pert, bo))

    sites = resnet50_sites(BATCH)
    check(len(sites) == INT8_LAYERS, f"{len(sites)} ResNet-50 sites")
    for i, (si, so) in enumerate(sites):  # (a)
        flip_and_combine(f"layer {i}", si, so, NUM_MC, shared=i == 0)
        # the draw loop's form (phase 26's launches): one salt, no lanes
        flip_and_combine(f"layer {i} one salt", si, so, 1, axis=None)
    torch.cuda.empty_cache()
    flip_and_combine("f32 layer 1", *sites[1], NUM_MC,  # (b)
                     dtype=torch.float32)
    flip_and_combine("f32 layer 1 one salt", *sites[1], 1, axis=None,
                     dtype=torch.float32)
    # (c) a rank's rows, a shard's channels, the LSTM's blocks
    half = resnet50_sites(BATCH // 2)
    with ts.draw_window(ts.DrawWindow(0, NUM_MC, NUM_MC, BATCH // 2,
                                      BATCH // 2, BATCH)):
        for i in (0, 10, 53):
            flip_and_combine(f"data=2 rank 1 layer {i}", *half[i], NUM_MC,
                             shared=i == 0)
    small = resnet50_sites(8)
    for i in (0, 10, 52):
        si, so = small[i]
        shard = so[:1] + (so[1] // 2,) + so[2:]
        with ts.tp_shard(1, 2, 1):
            flip_and_combine(f"model=2 shard 1 layer {i} NCHW", si, shard, 2)
        last = (si[0],) + si[2:] + (si[1],)
        shard_last = (so[0],) + so[2:] + (so[1] // 2,)
        with ts.tp_shard(1, 2, -1):
            flip_and_combine(f"model=2 shard 1 layer {i} NHWC", last,
                             shard_last, 2, axis=len(last) - 1)
    for feat in (1, LSTM_HIDDEN, 4 * LSTM_HIDDEN):
        whole = (LSTM_MC, LSTM_SEQ, LSTM_BATCH, feat)
        for start, shape in (((LSTM_MC // 2, 0, 0, 0),
                              (LSTM_MC // 2,) + whole[1:]),
                             ((0, 0, LSTM_BATCH // 2, 0),
                              whole[:2] + (LSTM_BATCH // 2, feat))):
            block = ts.SignBlock((ts.sign_salts(SEED + 1102)[0],), shape,
                                 whole, start)
            same("K-H1", f"LSTM block {shape} at {start} of {whole}",
                 kh.sign_flip(None, block, torch.float32, "cuda"),
                 kh.signs_plain(block, torch.float32, "cuda"))
    # (d) the INT8 sign products of one forward
    for scales in (QSIGN_SCALES, (0.2, 128.0, 0.2, 128.0, 0.2, 128.0)):
        sa, za, ss, zs, so_, zo = scales
        for i, (si, so) in enumerate(sites):
            for side, shape in ((0, si), (1, so)):
                a = torch.randint(0, 256, shape, generator=gen,
                                  device="cuda", dtype=torch.uint8)
                if side and a.dim() == 4:
                    a = a.contiguous(memory_format=torch.channels_last)
                block = ts.sign_block([ts.sign_salts(SEED + 1103, i)[side]],
                                      shape)
                same("K-H3", f"layer {i} side {side} {shape} scales "
                     f"{scales}", kh.qsign_mul(a, sa, za, block, ss, zs, so_,
                                               zo),
                     kh.qsign_mul_plain(a, sa, za, block, ss, zs, so_, zo))
    torch.cuda.empty_cache()
    int8_fused_checks(same, gen)
    log(f"[signs] {card()}: K-H and K-F's Flipout epilogue bit for bit with "
        f"their plain versions in {checked} checks (max |diff| {errs}): "
        f"the 54 layers' MC-{NUM_MC} bs{BATCH} activations in bf16, draw "
        f"axis and one salt, one layer in f32, the data=2 rows, the model=2 "
        f"shards (NCHW, NHWC), the LSTM's blocks, the INT8 forward's 108 "
        f"sign products; the INT8 Flipout layers' input passes and "
        f"perturbation GEMMs at the 54 layers (loop and draw axis, NCHW "
        f"and NHWC, a window's rows)")
    # (e) one MC-10 batch's sign work through the loop, kernel and plain
    res = {}
    for route in ("kernel", "plain"):
        work = sign_work(NUM_MC, BATCH, route=route)
        for name, (fn, nbytes, elements) in work.items():
            if route == "kernel":
                tag = QSIGN_TAG if name.startswith("K-H3") else SIGN_TAG
                bound_ms, bound_by = sign_bound(nbytes, elements)
                res[name] = dict(ms=device_times((fn, tag))[0],
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=None,
                                 max_abs_err=errs[name[:4]],
                                 gbytes=nbytes / 1e9)
            else:
                fn()
                res[name]["plain_ms"] = cuda_ms(fn)
        del work
        torch.cuda.empty_cache()
    for name, r in res.items():
        log(f"[signs] {name} over one MC-{NUM_MC} bs{BATCH} batch's sign "
            f"work through the loop ({r['gbytes']:.1f} GB): {r['ms']:.2f} "
            f"ms device time, plain {r['plain_ms']:.1f} ms, bound "
            f"{r['bound_ms']:.2f} ms ({r['bound_by']}), "
            f"{r['bound_ms'] / r['ms']:.2f} of the bound's rate")
    # K-H3 is the main path's input pass; its products (the float
    # inputs' form) ride along
    prod = res.pop("K-H3 products")
    res["K-H3"] = dict(res.pop("K-H3 input pass"), **{
        f"products_{k}": v for k, v in prod.items()
        if k in ("ms", "plain_ms", "bound_ms")})
    res["K-F flipout"] = flipout_gemm_times(errs["K-F flipout"])
    log(f"[signs] phase 46 took {time.perf_counter() - t0:.1f} s")
    return {k: {key: v for key, v in r.items() if key != "gbytes"}
            for k, r in res.items()}


def int8_fused_checks(same, gen):
    """(46 d') K-H3's input pass (a QTensor payload, channels-last as a
    layer's output gives it, requantized and multiplied by its signs: x_q
    and the product) and K-F's Flipout epilogue (the perturbation GEMM at
    the layer's (M, K, N), then its output signs' product and the add to
    the mean) against their plain versions with ``same``, at the 54 layers
    of the INT8 Flipout ResNet-50 at bs128: the loop's form (one salt)
    and the draw axis' (MC-2: both lanes, the mean two lanes wide), NCHW
    and NHWC; calibrated scales, and clamping ones in the loop's NCHW
    form; then at three layers under a window of rows (data=2)."""
    import torch

    from bayesian_torch_tpu_torch.ops import sampling as ts
    from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh
    from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kf

    sa, za, ss, zs, so, zo = QSIGN_SCALES

    def layout(shape, nhwc):
        """An NCHW shape in the layout, and its channel dim."""
        if len(shape) == 2:
            return shape, 1
        if nhwc:
            return (shape[0],) + shape[2:] + (shape[1],), len(shape) - 1
        return shape, 1

    def input_pass(what, si, lanes, nhwc):
        shape, cd = layout(si, nhwc)
        salts = [ts.sign_salts(SEED + 1104, s)[0] for s in range(lanes)]
        block = ts.sign_block(salts, shape, axis=cd if lanes > 1 else None)
        full = block.lanes_shape
        # the payload as a layer's output lies: lanes and channels inner
        inner = [cd] if lanes == 1 else [cd, cd + 1]
        order = [d for d in range(len(full)) if d not in inner] + inner
        a = torch.randint(0, 256, [full[d] for d in order], generator=gen,
                          device="cuda", dtype=torch.uint8).permute(
            *[order.index(d) for d in range(len(full))])
        for requant in ((0.037, 119), (sa, int(za))):
            got = kh.qsign_mul(a, sa, za, block, ss, zs, so, zo,
                               requant=requant)
            want = kh.qsign_mul_plain(a, sa, za, block, ss, zs, so, zo,
                                      requant=requant)
            for part, u, v in zip(("x_q", "product"), got, want):
                same("K-H3", f"{what} input pass {part} {full} {requant}",
                     u, v)

    def epilogue(what, so_shape, k, lanes, nhwc, scales):
        out, cd = layout(so_shape, nhwc)
        n = out[cd]
        m = math.prod(out) // n
        x = torch.randint(0, 256, (m, k), generator=gen, device="cuda",
                          dtype=torch.uint8)
        w = torch.randint(-128, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randn(n, generator=gen, device="cuda")
        mean = torch.randint(0, 256, (m, lanes * n), generator=gen,
                             device="cuda", dtype=torch.uint8)
        salts = [ts.sign_salts(SEED + 1105, s)[1] for s in range(lanes)]
        signs = kh.OutputSigns(ts.sign_block(
            salts, out, axis=cd if lanes > 1 else None), cd)
        # about 40 quanta a standard deviation of the product
        s7 = 0.031 * 0.0123 * 74 * 74 * k ** 0.5 / 40 * scales
        for lane in range(lanes):
            epi = kf.FlipoutEpilogue(
                mean[:, lane * n:(lane + 1) * n], 0.9 * s7, 121.0, signs,
                0.0079, 127.0, 1.1 * s7, 124.0, 1.6 * s7, 126.0, lane=lane)
            got = kf.qmatmul_requant_flipout(x, 0.031, 117, w, 0.0123, b,
                                             s7, 119, epi)
            want = kf.qmatmul_requant_flipout_plain(
                x, w, *kf.requant_args(w, 117, 0.031, 0.0123, b, s7), 119,
                s7, epi)
            same("K-F flipout", f"{what} lane {lane} of {lanes} {out} "
                 f"(M, K, N) = {(m, k, n)}", got, want)

    gemms = resnet50_gemms(BATCH)
    sites = resnet50_sites(BATCH)
    for i, ((si, _), (so_shape, k)) in enumerate(zip(sites, gemms)):
        for nhwc in (False, True):
            form = "NHWC" if nhwc else "NCHW"
            for lanes in (1, 2):
                input_pass(f"layer {i} {form}", si, lanes, nhwc)
                epilogue(f"layer {i} {form}", so_shape, k, lanes, nhwc, 1.0)
        epilogue(f"layer {i} clamping", so_shape, k, 1, False, 0.05)
        torch.cuda.empty_cache()
    half_sites, half_gemms = resnet50_sites(BATCH // 2), \
        resnet50_gemms(BATCH // 2)
    with ts.draw_window(ts.DrawWindow(0, 2, 2, BATCH // 2, BATCH // 2,
                                      BATCH)):
        for i in (0, 10, 53):
            for lanes in (1, 2):
                input_pass(f"data=2 rank 1 layer {i}", half_sites[i][0],
                           lanes, False)
                epilogue(f"data=2 rank 1 layer {i}", *half_gemms[i], lanes,
                         False, 1.0)


def flipout_gemm_times(err):
    """K-F's Flipout epilogue over one INT8 Flipout forward's 54
    perturbation GEMMs (``kernel_times.flipout_gemm_work``): its device
    time, its plain version's (CUDA events), the route before it (K-F,
    K-H3's product, torch's qadd: all its device rows) and the bound
    (bytes, or int8 operations)."""
    import torch

    work = {route: flipout_gemm_work(1, route)
            for route in ("kernel", "plain", "unfused")}
    fn, nbytes, flops, gemms = work["kernel"]
    bound_ms, bound_by = bound(nbytes, flops, INT8_OPS)
    ms, unfused_ms = device_times((fn, KF_FLIP_TAG),
                                  (work["unfused"][0], None))
    work["plain"][0]()
    res = dict(ms=ms, plain_ms=cuda_ms(work["plain"][0]),
               unfused_ms=unfused_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None, max_abs_err=err, gemms=gemms)
    del work, fn
    torch.cuda.empty_cache()
    log(f"[signs] K-F's Flipout epilogue over one INT8 Flipout forward's "
        f"{gemms} perturbation GEMMs: {ms:.3f} ms device time, the route "
        f"before it (K-F, K-H3, torch's qadd) {unfused_ms:.3f} ms, plain "
        f"{res['plain_ms']:.1f} ms, bound {bound_ms:.3f} ms ({bound_by}); "
        f"{card()}")
    return res


# --- model surgery: the deterministic ResNet-50, MOPED, dnn_to_bnn -----------

SURGERY_DELTA = 1e-4  # sigma = 1e-4 |w|: every draw close to the mean
PRIORS = {"prior_mu": 0.0, "prior_sigma": 1.0, "posterior_mu_init": 0.0,
          "posterior_rho_init": -3.0, "type": "Reparameterization",
          "moped_enable": True, "moped_delta": SURGERY_DELTA}


def phase_det(main_ms):
    """The deterministic ResNet-50: BN statistics from one batch; f32
    logits (TF32 off) against a CPU copy of the same weights on 4 images;
    bf16 forwards (conv and linear weights in bf16, BN parameters and
    statistics in f32) timed at bs128 and bs1280 as the main phase times
    its batches (``wall_ms``), and the
    10x-deterministic denominator ``min(t(bs1280), 10 x t(bs128))`` beside
    the main phase's MC-10 loop batch. Returns (model, x, f32 logits)."""
    import copy

    import torch
    from torch import nn

    from bayesian_torch_tpu_torch.models.deterministic.resnet_large import (
        resnet50,
    )

    det = resnet50(generator=torch.Generator().manual_seed(SEED + 3),
                   device="cuda")
    set_bn_statistics(det, images(SEED + 300))
    x = images(SEED + 1)
    with torch.no_grad(), tf32_off():
        logits = det(x)
    t0 = time.perf_counter()
    cpu = copy.deepcopy(det).cpu()
    with torch.no_grad():
        want = cpu(x[:4].cpu())
    del cpu
    diff, scale = max_err(logits[:4].cpu(), want), want.abs().max().item()
    log(f"[det] ResNet-50 f32 (TF32 off), card vs CPU copy on 4 images "
        f"({time.perf_counter() - t0:.1f} s): max|diff| {diff:.3e}, limit "
        f"2^-10 x max|logit| = {2**-10 * scale:.3e}")
    check(tuple(logits.shape) == (BATCH, 1000)
          and bool(torch.isfinite(logits).all()), "det logits")
    check(diff <= 2**-10 * scale, "card and CPU deterministic logits differ")

    bf16 = copy.deepcopy(det)
    for mod in bf16.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            mod.to(torch.bfloat16)
    big = torch.randn(BATCH * NUM_MC, 3, IMAGE, IMAGE,
                      generator=torch.Generator(device="cuda").manual_seed(
                          SEED + 301), device="cuda", dtype=torch.bfloat16)
    small = x.bfloat16()
    with torch.no_grad():
        t_small = wall_ms(lambda: bf16(small))
        t_big = wall_ms(lambda: bf16(big))
    del bf16, big
    torch.cuda.empty_cache()
    denom = min(t_big, NUM_MC * t_small)
    log(f"[det] {card()}: deterministic ResNet-50 bf16 {IMAGE}^2: "
        f"bs{BATCH} {t_small:.2f} ms, bs{BATCH * NUM_MC} {t_big:.2f} ms; "
        f"10x-deterministic denominator min(t(bs{BATCH * NUM_MC}), "
        f"{NUM_MC} x t(bs{BATCH})) = {denom:.2f} ms; the main phase's "
        f"MC-{NUM_MC} bs{BATCH} loop batch {main_ms:.2f} ms; ratio "
        f"{main_ms / denom:.3f}")
    return det, x, logits


def surgery_gates(what, model, x, det_logits):
    """A model initialised from the deterministic one at delta = 1e-4:
    its MC-10 loop mean (eval, presample on: one K-A launch) within 2^-6 x
    max|logit| of the deterministic f32 logits (TF32 off), and a finite
    ``get_kl_loss``."""
    import torch

    from bayesian_torch_tpu_torch.models.dnn_to_bnn import get_kl_loss
    from bayesian_torch_tpu_torch.parallel import mc_forward

    model.eval()
    reset_counts()
    with tf32_off():
        mean = mc_forward(model, x, NUM_MC, reduce="mean", return_kl=False)
    got = counts()
    diff, scale = max_err(mean, det_logits), det_logits.abs().max().item()
    kl = get_kl_loss(model).item()
    log(f"[{what}] MC-{NUM_MC} bs{BATCH} loop mean vs the deterministic "
        f"logits: max|diff| {diff:.3e}, limit 2^-6 x max|logit| = "
        f"{2**-6 * scale:.3e}; KL {kl:.1f}; launches "
        f"{ {k: v for k, v in got.items() if v} }")
    check(bool(torch.isfinite(mean).all()), f"{what}: non-finite mean")
    check(diff <= 2**-6 * scale, f"{what}: MC mean differs from the "
          "deterministic logits")
    check(got == dict(dict.fromkeys(got, 0), **{"K-A": 1}),
          f"{what}: launches {got}, want one K-A launch")
    check(math.isfinite(kl), f"{what}: KL {kl}")


def phase_surgery(det, x, det_logits):
    """MOPED into the Bayesian ResNet-50 and ``dnn_to_bnn`` of the
    deterministic one (moped_delta = 1e-4), each through
    ``surgery_gates``; then three MC-4 bs128 bf16 ELBO steps of a model
    converted at the default delta 0.5, through ``make_train_step``
    (emission "auto": vmap), launches as ``expected_vmap_launches`` reckons
    them. Returns the launches of the three steps."""
    import copy

    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step
    from bayesian_torch_tpu_torch.models import dnn_to_bnn
    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large \
        import resnet50
    from bayesian_torch_tpu_torch.parallel.mc import _resolve_emission
    from bayesian_torch_tpu_torch.utils import MOPED

    bayes = resnet50(generator=torch.Generator().manual_seed(SEED + 4),
                     device="cuda")
    t0 = time.perf_counter()
    MOPED(bayes, det, None, SURGERY_DELTA)
    log(f"[moped] MOPED(resnet50, det, None, delta={SURGERY_DELTA}): "
        f"{time.perf_counter() - t0:.2f} s")
    surgery_gates("moped", bayes, x, det_logits)
    keys = set(bayes.state_dict())
    del bayes

    converted = copy.deepcopy(det)
    dnn_to_bnn(converted, PRIORS)
    check(set(converted.state_dict()) == keys, "dnn_to_bnn: state_dict "
          "keys differ from resnet_variational_large.resnet50's")
    surgery_gates("dnn_to_bnn", converted, x, det_logits)
    del converted
    torch.cuda.empty_cache()

    model = copy.deepcopy(det)
    dnn_to_bnn(model, dict(PRIORS, moped_delta=0.5))
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.bfloat16
    model.train()
    emission = _resolve_emission(model, TRAIN_MC, True)
    check(emission == "vmap", f"emission 'auto' takes {emission!r}")
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(TRAIN_MC, BATCH)
    want = expected_vmap_launches(model, training=True)
    reset_counts()
    for i in range(3):
        before = counts()
        t0 = time.perf_counter()
        loss, nll, _ = step(model, opt, images(SEED + 430 + i),
                            labels(SEED + 430 + i))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v - before[k] for k, v in counts().items()}
        log(f"[dnn_to_bnn train] step {i}: {ms:.1f} ms, loss "
            f"{float(loss):.4f} (the converted layers return bare outputs: "
            f"the step's KL term is 0, as in JAX), launches "
            f"{ {k: v for k, v in got.items() if v} }")
        check(math.isfinite(float(loss)), f"dnn_to_bnn step {i}: loss")
        check(got == want, f"dnn_to_bnn step {i}: launches {got}, the "
              f"model implies {want}")
    launches = counts()
    del model, opt
    torch.cuda.empty_cache()
    return launches


def phase_surgery_trainers():
    """The four model-surgery trainers at full ResNet-50 width, batch 32,
    one epoch each: the deterministic trainer (train, then test), the
    Bayesian trainer with ``--moped`` from its checkpoint, the
    ``dnn_to_bnn`` trainer (train, then test) and the INT8 pipeline on
    its checkpoint with conv+BN folding and uint8 activations."""
    import io
    import os
    import tempfile

    from bayesian_torch_tpu_torch.examples import (
        main_bayesian_imagenet,
        main_bayesian_imagenet_bnn2qbnn,
        main_bayesian_imagenet_dnn2bnn,
        main_deterministic_imagenet,
    )

    def run(mod, *args):
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = mod.main(["--synthetic", f"--batch-size={TRAINER_BATCH}",
                               *args])
        got = counts()
        lines = out.getvalue().strip().splitlines()
        log(f"[{mod.__name__.rsplit('.', 1)[-1]}] {' '.join(args[:2])}: "
            f"{time.perf_counter() - t0:.1f} s, launches "
            f"{ {k: v for k, v in got.items() if v} }; last lines: "
            f"{' | '.join(lines[-2:])}")
        return result, got

    with tempfile.TemporaryDirectory() as tmp:
        det_dir, d2b = os.path.join(tmp, "det"), os.path.join(tmp, "d2b")
        acc, _ = run(main_deterministic_imagenet, "--mode=train",
                     "--epochs=1", f"--save_dir={det_dir}")
        check(0.0 <= acc <= 1.0, f"deterministic accuracy {acc}")
        tested, _ = run(main_deterministic_imagenet, "--mode=test",
                        f"--save_dir={det_dir}")
        check(0.0 <= tested <= 1.0, f"deterministic test accuracy {tested}")
        metrics, got = run(
            main_bayesian_imagenet, "--mode=train", "--moped",
            f"--moped-ckpt={det_dir}/imagenet_det_resnet50.pt",
            "--epochs=1", "--num_monte_carlo=2",
            f"--save_dir={os.path.join(tmp, 'moped')}")
        check(0.0 <= metrics["accuracy"] <= 1.0, f"--moped {metrics}")
        check(got["K-A"] > 0 and got["K-C drho"] > 0,
              "the --moped steps did not go through K-A and K-C (drho)")
        metrics, _ = run(main_bayesian_imagenet_dnn2bnn, "--mode=train",
                         "--epochs=1", "--num_monte_carlo=2",
                         f"--save_dir={d2b}")
        check(0.0 <= metrics["accuracy"] <= 1.0, f"dnn2bnn {metrics}")
        tested, _ = run(main_bayesian_imagenet_dnn2bnn, "--mode=test",
                        "--num_monte_carlo=2", f"--save_dir={d2b}")
        check(0.0 <= tested["accuracy"] <= 1.0, f"dnn2bnn test {tested}")
        out, got = run(main_bayesian_imagenet_bnn2qbnn,
                       "--fuse-conv-bn", "--quantize-activations",
                       f"--bnn-ckpt={d2b}/imagenet_dnn2bnn_resnet50.pt")
        check(got["K-F"] > 0, "bnn2qbnn: K-F never launched")
        check(0.0 <= out["int8"]["accuracy"] <= 1.0, f"bnn2qbnn {out}")
    return got["K-F"]


def phase_entry():
    """``graft_entry.entry()`` in its default form, on the card."""
    import torch

    from bayesian_torch_tpu_torch.graft_entry import entry

    fn, args = entry()
    reset_counts()
    t0 = time.perf_counter()
    logits, kl = fn(*args)
    torch.cuda.synchronize()
    log(f"[entry] graft_entry.entry(): logits {tuple(logits.shape)} on "
        f"{logits.device}, KL {float(kl):.1f}, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, launches "
        f"{ {k: v for k, v in counts().items() if v} }")
    check(logits.is_cuda and tuple(logits.shape) == (2, 1000)
          and bool(torch.isfinite(logits).all()), "entry() output")


# --- the small-model zoo: ConvTranspose, the SCNN, the CIFAR ResNets ---------

# (nd, in_ch, out_ch, k, stride, padding, output_padding, dilation, groups):
# the geometry cases of tests/test_conv_ops.py::CONVT_CASES
CONVT_CASES = [
    (1, 4, 6, 3, 1, 0, 0, 1, 1),
    (1, 6, 4, 4, 2, 1, 1, 1, 2),
    (2, 3, 5, 3, 2, 1, 1, 1, 1),
    (2, 4, 8, (3, 5), (2, 3), (1, 2), (1, 2), 1, 1),
    (2, 6, 6, 3, 2, 0, 1, 2, 3),
    (3, 2, 4, 3, 2, 1, 1, 1, 1),
]
CIFAR_ARCH = "resnet110"
CIFAR_BATCH = 128
CIFAR_TEST_BATCH = 1000
CIFAR_MC = 50  # the CIFAR trainers' --num_monte_carlo
MNIST_BATCH = 64
MNIST_MC = 20
INT8_MC = 20  # the dnn2bnn trainer's --num_monte_carlo
ESTIMATORS = ("Reparameterization", "Flipout")


def zoo_images(n, shape, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n,) + shape, generator=gen).to("cuda")


def zoo_labels(n, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 10, (n,), generator=gen).to("cuda")


def rewound(layers, fn):
    """``fn()`` with every layer's generator rewound after it."""
    gens = {id(m.generator): m.generator for m in layers}.values()
    states = [g.get_state() for g in gens]
    try:
        return fn()
    finally:
        for g, st in zip(gens, states):
            g.set_state(st)


def quiet(fn, *args):
    """``fn(*args)`` with its prints captured; returns (result, seconds,
    the last two lines printed)."""
    import io

    import torch

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    torch.cuda.synchronize()
    lines = out.getvalue().strip().splitlines()
    return result, time.perf_counter() - t0, " | ".join(lines[-2:])


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def phase_transposed():
    """(a) The six ConvTranspose layers on the geometry cases, with
    injected eps (and Flipout signs), against a CPU copy (f32, TF32 off),
    within 1e-4 x max|CPU|; then a Conv -> ConvTranspose model through
    the vmap emission lane for lane against its draw loop on the same
    presampled draws (eval, presample on: one K-A launch each), within
    2^-6 x max|out|. Returns the K-A launches of the two runs."""
    import copy

    import torch
    from torch import nn

    import bayesian_torch_tpu_torch.layers as tl
    from bayesian_torch_tpu_torch.nn import BatchNorm2d
    from bayesian_torch_tpu_torch.ops.conv import conv_transpose_nd
    from bayesian_torch_tpu_torch.parallel import mc_forward

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 700)
    worst = 0.0
    for nd, ci, co, k, s, p, op, d, g in CONVT_CASES:
        geometry = dict(stride=s, padding=p, output_padding=op, dilation=d,
                        groups=g)
        x = torch.randn((8, ci) + (16,) * nd, generator=gen)
        for est in ESTIMATORS:
            layer = getattr(tl, f"ConvTranspose{nd}d{est}")(
                ci, co, k, generator=torch.Generator().manual_seed(SEED),
                device="cuda", **geometry)
            out_shape = conv_transpose_nd(
                x[:1], layer.mu_kernel.detach().cpu(), **geometry).shape
            noise = dict(eps_k=torch.randn(layer.mu_kernel.shape,
                                           generator=gen),
                         eps_b=torch.randn(co, generator=gen))
            if est == "Flipout":
                noise["sign_in"] = torch.randint(
                    0, 2, x.shape, generator=gen).float() * 2 - 1
                noise["sign_out"] = torch.randint(
                    0, 2, (8,) + tuple(out_shape[1:]), generator=gen
                ).float() * 2 - 1
            with torch.no_grad(), tf32_off():
                got, _ = layer(x.to("cuda"), **{n: v.to("cuda")
                                                for n, v in noise.items()})
                want, _ = copy.deepcopy(layer).cpu()(x, **noise)
            err = max_err(got.cpu(), want) / want.abs().max().item()
            check(tuple(got.shape) == tuple(want.shape)
                  and bool(torch.isfinite(got).all()),
                  f"ConvTranspose{nd}d{est}: output")
            check(err <= 1e-4, f"ConvTranspose{nd}d{est} {geometry}: card "
                  f"and CPU differ by {err:.3e} of max|CPU|")
            worst = max(worst, err)
    log(f"[transposed] ConvTranspose{{1,2,3}}d in both estimators on "
        f"{len(CONVT_CASES)} geometry cases (batch 8, 16 per side), "
        f"injected noise, f32 TF32 off: worst max|card - CPU| / max|CPU| = "
        f"{worst:.3e}, limit 1e-4 ({time.perf_counter() - t0:.1f} s)")

    class UpNet(nn.Module):
        def __init__(self, gen):
            super().__init__()
            kw = dict(generator=gen, device="cuda")
            self.down = tl.Conv2dReparameterization(3, 32, 3, stride=2,
                                                    padding=1, **kw)
            self.bn = BatchNorm2d(32, device="cuda")
            self.up = tl.ConvTranspose2dReparameterization(
                32, 16, 3, stride=2, padding=1, output_padding=1, **kw)
            self.head = tl.LinearReparameterization(16, 10, **kw)

        def forward(self, x):
            out, kl = self.down(x)
            out = torch.relu(self.bn(out))
            out, kl_up = self.up(out)
            out, kl_head = self.head(torch.relu(out).mean(dim=(2, 3)))
            return out, kl + kl_up + kl_head

    model = UpNet(torch.Generator().manual_seed(SEED + 701)).eval()
    layers = [model.down, model.up, model.head]
    x = zoo_images(CIFAR_BATCH, (3, 32, 32), SEED + 702)
    runs, paths = {}, {}
    for emission in ("vmap", "scan"):
        reset_counts()
        runs[emission] = rewound(layers, lambda: mc_forward(
            model, x, 10, presample="on", return_kl=False,
            emission=emission))
        torch.cuda.synchronize()
        paths[f"ConvTranspose model MC-10 {emission}"] = counts()
        check(counts()["K-A"] == 1, f"UpNet {emission}: K-A launched "
              f"{counts()['K-A']} times, want 1")
    vmap, loop = runs["vmap"], runs["scan"]
    diff, scale = max_err(vmap, loop), loop.abs().max().item()
    log(f"[transposed] Conv -> ConvTranspose model, MC-10 bs{CIFAR_BATCH} "
        f"32^2 f32: vmap emission vs the loop on the same presampled draws: "
        f"max|diff| {diff:.3e}, limit 2^-6 x max|out| = {2**-6 * scale:.3e}")
    check(tuple(vmap.shape) == (10, CIFAR_BATCH, 10)
          and diff <= 2**-6 * scale, "UpNet: vmap and loop lanes differ")
    return paths


def zoo_draw_sizes(*models):
    """The distinct sizes of the models' draw buffers: each weight and
    each bias (the draw loop's K-A rho mode and K-C drho) and each layer's
    weight and bias as one flat buffer (the vmap emission's K-A at S draws
    and K-C dsigma)."""
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )

    sizes = set()
    for model in models:
        for layer in iter_bayesian_layers(model):
            numels = [p.numel() for name, p in layer.named_parameters()
                      if name.startswith("mu_")]
            sizes.update(numels)
            sizes.add(sum(numels))
    return sorted(sizes)


def presample_check(what, model, num_mc):
    """K-A at ``num_mc`` draws over the model's whole flat posterior, f32,
    as the MC evaluation's presample draws it, against its plain version
    within 1e-5."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka

    mu, sigma = flat_posterior(model)
    seed = 0x5EED_0000_0000_0200
    err = max_err(
        ka.sample_scaled_normals_batch(seed, mu, sigma, num_mc,
                                       torch.float32),
        ka.sample_scaled_normals_batch_plain(seed, mu, sigma, num_mc,
                                             torch.float32))
    log(f"[K-A presample] {what}: n={mu.numel()} S={num_mc} f32 "
        f"max|kernel-plain|={err:.3e} (limit 1e-5)")
    check(err <= 1e-5, f"K-A off its plain version at {what}'s presample")


def cifar_model(arch, estimator="Reparameterization"):
    import torch

    from bayesian_torch_tpu_torch.examples.main_bayesian_cifar import (
        get_model,
    )
    return get_model(arch, SEED + 720, estimator, torch.device("cuda"))


def trainer_launches(what, mod, argv, want=None):
    """Run a trainer's ``main(argv)`` with every count set to 0 before it;
    log its seconds, launches and last lines; check the launches against
    ``want`` (the kernels named there) if given. Returns (result,
    launches, seconds)."""
    reset_counts()
    result, secs, tail = quiet(mod.main, argv)
    got = counts()
    log(f"[{what}] {mod.__name__.rsplit('.', 1)[-1]} {' '.join(argv)}: "
        f"{secs:.1f} s, launches {nonzero(got)}; last lines: {tail}")
    if want is not None:
        check(all(got[k] == v for k, v in want.items()),
              f"{what}: launches {nonzero(got)}, want {want}")
    return result, got, secs


def timed_steps(what, model, step, inputs, want, reps=3):
    """One warm-up and ``reps`` timed steps ``step(x, y)`` (host clock to
    synchronize), the launches of each step checked against ``want``;
    returns (median ms, peak GiB)."""
    import torch

    step(*inputs(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(reps):
        x, y = inputs(i + 1)
        before = counts()
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in counts().items()}
        check(math.isfinite(float(loss)), f"{what}: loss {float(loss)}")
        if want is not None:
            check(got == want, f"{what} step {i}: launches {nonzero(got)}, "
                  f"want {nonzero(want)}")
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch = x.shape[0]
    log(f"[{what}] steps {', '.join(f'{t:.1f}' for t in times)} ms: median "
        f"{ms:.2f} ms/step, {batch / ms * 1e3:.1f} images/s, peak "
        f"{peak:.2f} GiB; launches per step "
        f"{nonzero(want) if want is not None else 'not gated'}")
    return ms, peak


def elbo_step(model, num_mc, batch, emission="auto"):
    """The CIFAR trainer's step: ``make_train_step`` with Adam."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step

    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    fn = make_train_step(num_mc, batch, emission=emission)
    return lambda x, y: fn(model, opt, x, y)[0]


def phase_cifar(cap_train, cap_test):
    """(b) The Bayesian CIFAR ResNet-110 (reparameterization) at its full
    widths (16/32/64), batch 128, 32^2, f32 (cuDNN's default TF32
    convolutions): the trainer for one epoch with its MC-50 evaluation,
    K-A and K-C (drho) launches counted exactly; ms per ELBO step at MC-1
    (the draw loop) and MC-4 (emission "auto": vmap), peak memory, device
    busy time and idle share of one step of each; ms per MC-50 batch at
    bs1000; the rho = -30 and rho = -60 sanity gates. First K-A and K-C
    against their plain versions at every draw buffer of the ResNet and
    the SCNN (``layer_sweep``) and K-A over their whole posteriors at the
    evaluations' MC-50 and MC-20. Returns {path: launches}."""
    import tempfile

    import torch

    from bayesian_torch_tpu_torch.examples import main_bayesian_cifar
    from bayesian_torch_tpu_torch.models.bayesian.simple_cnn_variational \
        import SCNN
    from bayesian_torch_tpu_torch.parallel import mc_forward
    from bayesian_torch_tpu_torch.parallel.mc import _resolve_emission

    paths = {}
    model = cifar_model(CIFAR_ARCH)
    per_step = expected_step_launches(model, 1)
    n_weights = per_step["K-A"]
    depth = int(CIFAR_ARCH[len("resnet"):])
    check(n_weights == depth + 1, f"{CIFAR_ARCH}: {n_weights} weight draws "
          f"a step, want {depth + 1} ({depth - 1} convs, the head's weight "
          "and bias)")
    scnn = SCNN(generator=torch.Generator().manual_seed(SEED + 740),
                device="cuda")
    layer_sweep(zoo_draw_sizes(model, scnn),
                f"the {CIFAR_ARCH}'s and the SCNN's draw buffers")
    presample_check(CIFAR_ARCH, model, CIFAR_MC)
    presample_check("the SCNN", scnn, MNIST_MC)
    del scnn
    steps, evals = cap_train // CIFAR_BATCH, cap_test // CIFAR_TEST_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        metrics, got, secs = trainer_launches(
            "cifar trainer", main_bayesian_cifar,
            ["--arch", CIFAR_ARCH, "--synthetic", "--epochs", "1",
             f"--batch-size={CIFAR_BATCH}",
             f"--test-batch-size={CIFAR_TEST_BATCH}",
             f"--num_monte_carlo={CIFAR_MC}", "--device=cuda",
             f"--save_dir={tmp}"],
            {"K-A": steps * n_weights + evals,
             "K-C drho": steps * n_weights, "K-C dsigma": 0, "K-F": 0})
    check(0.0 <= metrics["accuracy"] <= 1.0, f"cifar trainer {metrics}")
    paths["cifar trainer"] = got

    x = zoo_images(CIFAR_BATCH, (3, 32, 32), SEED + 721)
    y = zoo_labels(CIFAR_BATCH, SEED + 721)
    model.train()
    check(_resolve_emission(model, 4, True) == "vmap",
          "emission 'auto' does not take vmap at MC-4")
    for num_mc, want in ((1, per_step),
                         (4, expected_vmap_launches(model, training=True))):
        what = (f"cifar {CIFAR_ARCH} MC-{num_mc} "
                f"{'loop' if num_mc == 1 else 'vmap'} step")
        step = elbo_step(model, num_mc, CIFAR_BATCH)
        reset_counts()
        ms, peak = timed_steps(what, model, step, lambda i: (x, y), want)
        paths[what] = counts()
        prof = profile_window(f"one {what} (bs{CIFAR_BATCH})",
                              lambda: step(x, y), rows=12)
        wall, busy = prof["wall"], prof["busy"]
        log(f"[{what}] device busy {busy:.1f} ms of {wall:.1f} ms under "
            f"the profiler, idle share {1 - busy / wall:.3f}")
        check_grads(model, what)

    model.eval()
    xt = zoo_images(CIFAR_TEST_BATCH, (3, 32, 32), SEED + 722)
    reset_counts()
    mean = None

    def mc50():
        nonlocal mean
        mean = mc_forward(model, xt, CIFAR_MC, reduce="mean",
                          return_kl=False)

    ms = wall_ms(mc50, reps=3)
    paths[f"cifar MC-{CIFAR_MC} bs{CIFAR_TEST_BATCH} batches"] = counts()
    check(counts()["K-A"] == 4, f"MC-{CIFAR_MC}: {counts()['K-A']} K-A "
          "launches in 4 batches, want 4")
    check(tuple(mean.shape) == (CIFAR_TEST_BATCH, 10)
          and bool(torch.isfinite(mean).all()), "MC-50 mean")
    log(f"[cifar eval] {card()}: {CIFAR_ARCH} MC-{CIFAR_MC} "
        f"bs{CIFAR_TEST_BATCH} 32^2 f32 (the loop, presample on): median "
        f"{ms:.1f} ms/batch, {CIFAR_TEST_BATCH / ms * 1e3:.1f} images/s, "
        f"{CIFAR_TEST_BATCH * CIFAR_MC / ms * 1e3:.0f} image-draws/s")
    zoo_mc_sanity(model, xt[:CIFAR_BATCH])
    zoo_vmap_step_sanity(model, x, y)
    return paths


def zoo_mc_sanity(model, x):
    """rho = -30: the MC-50 mean within 2^-6 x max|logit| of one draw."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    saved = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "rho" in name:
                    p.fill_(-30.0)
        many = mc_forward(model, x, CIFAR_MC, reduce="mean", return_kl=False)
        one = mc_forward(model, x, 1, reduce="mean", return_kl=False)
    finally:
        model.load_state_dict(saved)
    diff, scale = max_err(many, one), one.abs().max().item()
    log(f"[cifar sanity] rho=-30: max|MC-{CIFAR_MC} mean - one draw| = "
        f"{diff:.3e}, limit 2^-6 x max|logit| = {2**-6 * scale:.3e}")
    check(diff <= 2**-6 * scale, "rho=-30: the MC-50 mean differs from a "
          "draw")


def zoo_vmap_step_sanity(model, x, y):
    """rho = -60, f32 with TF32 off: a vmap MC-4 step and a loop MC-4 step
    from the same state give the same loss, mu gradients and running
    statistics, within 2^-6 of each tensor's largest value."""
    import torch

    saved = {k: v.clone() for k, v in model.state_dict().items()}

    def step_from_saved(emission):
        model.load_state_dict(saved)
        model.train()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "rho" in name:
                    p.fill_(-60.0)
        for p in model.parameters():
            p.grad = None
        loss = elbo_step(model, 4, x.shape[0], emission)(x, y)
        out = {n: p.grad.clone() for n, p in model.named_parameters()
               if "mu_" in n}
        out.update({k: v.clone() for k, v in model.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))})
        return float(loss), out

    try:
        with tf32_off():
            loss_v, vmap = step_from_saved("vmap")
            loss_l, loop = step_from_saved("scan")
    finally:
        model.load_state_dict(saved)
    err, name = max((max_err(vmap[k], loop[k])
                     / max(loop[k].abs().max().item(), 1e-30), k)
                    for k in loop)
    log(f"[cifar sanity] rho=-60, f32 TF32 off: vmap and loop MC-4 steps: "
        f"loss {loss_v:.6f} and {loss_l:.6f}; worst max|diff| / max|loop| "
        f"over {len(loop)} mu gradients and running statistics = {err:.3e} "
        f"({name}), limit 2^-6")
    check(abs(loss_v - loss_l) <= 2**-6 * abs(loss_l)
          and err <= 2**-6, f"rho=-60: the vmap and loop steps differ at "
          f"{name}")


def phase_flipout_cifar(cap_train, cap_test):
    """(c) The Flipout CIFAR trainer at resnet20 for one epoch with its
    MC-4 evaluation (launches exact), and its MC-1 step timed."""
    import tempfile

    from bayesian_torch_tpu_torch.examples import main_bayesian_flipout_cifar

    model = cifar_model("resnet20", "Flipout")
    per_step = expected_step_launches(model, 1)
    steps, evals = cap_train // CIFAR_BATCH, cap_test // CIFAR_TEST_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        metrics, got, _ = trainer_launches(
            "flipout cifar trainer", main_bayesian_flipout_cifar,
            ["--arch", "resnet20", "--synthetic", "--epochs", "1",
             f"--batch-size={CIFAR_BATCH}",
             f"--test-batch-size={CIFAR_TEST_BATCH}",
             "--num_monte_carlo=4", "--device=cuda",
             f"--save_dir={tmp}"],
            {"K-A": steps * per_step["K-A"] + evals,
             "K-C drho": steps * per_step["K-A"]})
    check(0.0 <= metrics["accuracy"] <= 1.0, f"flipout trainer {metrics}")
    x = zoo_images(CIFAR_BATCH, (3, 32, 32), SEED + 730)
    y = zoo_labels(CIFAR_BATCH, SEED + 730)
    model.train()
    timed_steps("flipout cifar resnet20 MC-1 step", model,
                elbo_step(model, 1, CIFAR_BATCH), lambda i: (x, y), per_step)
    return {"flipout cifar trainer": got}


def det_step(model, loss_fn, opt):
    def step(x, y):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def phase_small_trainers(cap_train, cap_test):
    """(d) The deterministic CIFAR ResNet-20 and MNIST SCNN trainers and the
    Bayesian MNIST trainer (bs64, one epoch, MC-20 evaluation), each
    step timed; the SCNN's vmap MC-4 log-probabilities sum to 1 in every
    draw."""
    import tempfile

    import torch
    import torch.nn.functional as F

    from bayesian_torch_tpu_torch.examples import (main_bayesian_mnist,
                                                   main_deterministic_cifar,
                                                   main_deterministic_mnist)
    from bayesian_torch_tpu_torch.examples._engine import (make_optimizer,
                                                           make_train_step)
    from bayesian_torch_tpu_torch.models.bayesian.simple_cnn_variational \
        import SCNN
    from bayesian_torch_tpu_torch.models.deterministic import resnet
    from bayesian_torch_tpu_torch.models.deterministic.simple_cnn import (
        SCNN as DetSCNN,
    )
    from bayesian_torch_tpu_torch.parallel import mc_forward

    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mod, extra in ((main_deterministic_cifar,
                            ["--arch", "resnet20",
                             f"--batch-size={CIFAR_BATCH}",
                             f"--test-batch-size={CIFAR_TEST_BATCH}"]),
                           (main_deterministic_mnist,
                            [f"--batch-size={MNIST_BATCH}",
                             f"--test-batch-size={CIFAR_TEST_BATCH}"])):
            acc, got, _ = trainer_launches(
                "det trainer", mod, ["--synthetic", "--epochs", "1",
                                     "--device=cuda",
                                     f"--save_dir={tmp}", *extra],
                dict.fromkeys(kernel_counters(), 0))
            check(0.0 <= acc <= 1.0, f"{mod.__name__}: accuracy {acc}")
        scnn = SCNN(generator=torch.Generator().manual_seed(SEED + 740),
                    device="cuda")
        per_step = expected_step_launches(scnn, 1)
        steps = cap_train // MNIST_BATCH
        metrics, got, _ = trainer_launches(
            "mnist trainer", main_bayesian_mnist,
            ["--synthetic", "--epochs", "1", f"--batch-size={MNIST_BATCH}",
             f"--test-batch-size={CIFAR_TEST_BATCH}",
             f"--num_monte_carlo={MNIST_MC}", "--device=cuda",
             f"--save_dir={tmp}/bayes"],
            {"K-A": steps * per_step["K-A"] + cap_test // CIFAR_TEST_BATCH,
             "K-C drho": steps * per_step["K-A"]})
        check(0.0 <= metrics["accuracy"] <= 1.0, f"mnist {metrics}")
        paths["mnist trainer"] = got

    gen = torch.Generator().manual_seed(SEED + 741)
    det20 = resnet.resnet20(generator=gen, device="cuda").train()
    xc = zoo_images(CIFAR_BATCH, (3, 32, 32), SEED + 742)
    yc = zoo_labels(CIFAR_BATCH, SEED + 742)
    timed_steps("det cifar resnet20 step", det20, det_step(
        det20, F.cross_entropy, torch.optim.SGD(det20.parameters(), lr=0.1,
                                                momentum=0.9)),
        lambda i: (xc, yc), dict.fromkeys(kernel_counters(), 0))
    xm = zoo_images(MNIST_BATCH, (1, 28, 28), SEED + 743)
    ym = zoo_labels(MNIST_BATCH, SEED + 743)
    det_scnn = DetSCNN(generator=gen, device="cuda").train()
    timed_steps("det mnist scnn step", det_scnn, det_step(
        det_scnn, F.nll_loss, make_optimizer(det_scnn, 1.0, "adadelta")),
        lambda i: (xm, ym), dict.fromkeys(kernel_counters(), 0))
    scnn.train()
    opt = make_optimizer(scnn, 1.0, "adadelta")
    fn = make_train_step(1, MNIST_BATCH)
    reset_counts()
    timed_steps("bayesian mnist scnn MC-1 step", scnn,
                lambda x, y: fn(scnn, opt, x, y)[0], lambda i: (xm, ym),
                per_step)
    paths["bayesian mnist scnn MC-1 steps"] = counts()

    scnn.eval()
    reset_counts()
    log_probs = mc_forward(scnn, xm, 4, emission="vmap", return_kl=False)
    torch.cuda.synchronize()
    sums = log_probs.float().exp().sum(-1)
    err = (sums - 1).abs().max().item()
    log(f"[scnn vmap] MC-4 bs{MNIST_BATCH} through the vmap emission: every "
        f"draw's probabilities sum to 1 within {err:.2e} (limit 1e-4); "
        f"launches {nonzero(counts())}")
    check(tuple(log_probs.shape) == (4, MNIST_BATCH, 10) and err <= 1e-4,
          "SCNN vmap: the log_softmax is not taken per draw")
    return paths


def phase_zoo_int8(cap_test):
    """(e) The CIFAR dnn2bnn trainer's PTQ mode at resnet20 (float MC-20
    evaluation, calibration, convert, INT8 MC-20 evaluation: K-F launches
    exact) and ``quantization_test``; a calibrated INT8 CIFAR ResNet-20
    (conv+BN folding, uint8 activations through the option-A shortcut):
    K-F bit for bit at its GEMM shapes at bs128 and at the SCNN's,
    INT8 MC-20 bs1000 timed, and the card's logits with frozen draws
    against a CPU copy. Returns ({path: launches}, K-F's results at the
    CIFAR shapes)."""
    import copy
    import tempfile

    import torch

    from bayesian_torch_tpu_torch.examples import (
        main_bayesian_cifar_dnn2bnn, quantization_test)
    from bayesian_torch_tpu_torch.models.bayesian.simple_cnn_variational \
        import SCNN
    from bayesian_torch_tpu_torch.ops.qtensor import dequantize_if_qtensor
    from bayesian_torch_tpu_torch.parallel import mc_forward
    from bayesian_torch_tpu_torch.quantization import (convert,
                                                       freeze_quantized_draws,
                                                       prepare)
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state

    paths = {}
    layers20 = 20  # resnet20: 19 convs and the head, one K-F launch each
    with tempfile.TemporaryDirectory() as tmp:
        out, got, _ = trainer_launches(
            "cifar ptq", main_bayesian_cifar_dnn2bnn,
            ["--mode=ptq", "--arch", "resnet20", "--synthetic",
             f"--batch-size={CIFAR_BATCH}",
             f"--test-batch-size={CIFAR_TEST_BATCH}",
             f"--num_monte_carlo={INT8_MC}", "--device=cuda",
             f"--save_dir={tmp}"],
            {"K-F": layers20 * INT8_MC * (cap_test // CIFAR_TEST_BATCH)})
    check(set(out) == {"float", "int8"}
          and all(0.0 <= m["accuracy"] <= 1.0 for m in out.values()),
          f"cifar ptq {out}")
    log(f"[cifar ptq] {card()}: float MC-{INT8_MC} bs{CIFAR_TEST_BATCH} "
        f"{out['float']['imgs_per_sec']:.1f} images/s, INT8 MC-{INT8_MC} "
        f"{out['int8']['imgs_per_sec']:.1f} images/s; accuracy "
        f"{out['float']['accuracy']:.4f} and {out['int8']['accuracy']:.4f}")
    paths["cifar ptq trainer"] = got
    (log_probs, kl), got, _ = trainer_launches(
        "quantization_test", quantization_test, ["--device=cuda"],
        {"K-F": 4})
    check(tuple(log_probs.shape) == (1, 10)
          and abs(log_probs.exp().sum().item() - 1) < 1e-4,
          "quantization_test output")
    paths["quantization_test"] = got

    model = cifar_model("resnet20")
    xc = zoo_images(CIFAR_BATCH, (3, 32, 32), SEED + 750)
    set_bn_statistics(model, xc)
    prepare(model)
    with torch.no_grad():
        model(xc)
    convert(model, fuse_conv_bn=True, quantize_activations=True)
    scnn = SCNN(generator=torch.Generator().manual_seed(SEED + 751),
                device="cuda").eval()
    prepare(scnn)
    xm = zoo_images(1, (1, 28, 28), SEED + 752)
    with torch.no_grad():
        scnn(xm)
    convert(scnn)
    with torch.no_grad():
        cifar_shapes = int8_shapes(model, xc)
        scnn_shapes = int8_shapes(scnn, xm)
    log(f"[zoo K-F] CIFAR resnet20 bs{CIFAR_BATCH} GEMMs (M, K, N): "
        f"{dict(cifar_shapes)}; SCNN bs1: {dict(scnn_shapes)}")
    kf_res = phase_qmatmul(cifar_shapes)
    phase_qmatmul(scnn_shapes)

    xt = zoo_images(CIFAR_TEST_BATCH, (3, 32, 32), SEED + 753)
    reset_counts()
    ms = wall_ms(lambda: mc_forward(model, xt, INT8_MC, reduce="mean",
                                    return_kl=False), reps=3)
    paths[f"cifar int8 MC-{INT8_MC} bs{CIFAR_TEST_BATCH} batches"] = counts()
    check(counts()["K-F"] == 4 * INT8_MC * layers20, f"INT8 MC-{INT8_MC}: "
          f"K-F {counts()['K-F']} in 4 batches, want "
          f"{4 * INT8_MC * layers20}")
    log(f"[cifar int8] {card()}: resnet20 INT8 (calibrated, conv+BN folded, "
        f"uint8 activations) MC-{INT8_MC} bs{CIFAR_TEST_BATCH}: median "
        f"{ms:.1f} ms/batch, {CIFAR_TEST_BATCH / ms * 1e3:.1f} images/s")

    check(freeze_quantized_draws(model) == layers20, "froze the layers")
    cpu = copy.deepcopy(cifar_model("resnet20")).cpu()
    prepare(cpu)
    convert(cpu, fuse_conv_bn=True, quantize_activations=True)
    load_jax_quant_state(
        cpu, {k: v.cpu().numpy() for k, v in model.state_dict().items()},
        {name: m.quant_dict for name, m in model.named_modules()
         if hasattr(m, "quant_dict")})
    feats = {}

    def run(m, x):
        h = m.layer3[-1].register_forward_hook(
            lambda mod, inp, out: feats.__setitem__(
                x.device.type, dequantize_if_qtensor(out[0]).cpu()))
        try:
            with torch.no_grad():
                return m(x)[0].cpu()
        finally:
            h.remove()

    got, want = run(model, xc[:2]), run(cpu, xc[:2].cpu())
    head_q = model.linear.quant_dict[4]["scale"]
    diff = (got - want).abs()
    exact = torch.equal(feats["cuda"], feats["cpu"])
    log(f"[cifar int8 sanity] card vs CPU copy, frozen draws, 2 images: the "
        f"activations out of layer3 equal: {exact}; logits max|diff| "
        f"{diff.max().item() / head_q:.2f} head quanta (limit 3)")
    check(exact and diff.max().item() <= 3 * head_q * (1 + 1e-6),
          "INT8 CIFAR: card and CPU copy differ")
    return paths, kf_res


def phase_zoo():
    """Phases (a) to (e) of the small-model zoo, each one's seconds
    logged; returns ({kernel: {path: launches}} for K-A, K-C (both modes)
    and K-F, K-F's results at the CIFAR ResNet-20's shapes)."""
    import torch

    from bayesian_torch_tpu_torch.examples import _data

    caps = (_data._SYNTH_TRAIN_CAP, _data._SYNTH_TEST_CAP)
    paths, seconds = {}, {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
        return out

    paths.update(timed("transposed", phase_transposed))
    paths.update(timed("cifar", phase_cifar, *caps))
    paths.update(timed("flipout cifar", phase_flipout_cifar, *caps))
    paths.update(timed("small trainers", phase_small_trainers, *caps))
    int8_paths, kf_res = timed("int8", phase_zoo_int8, caps[1])
    paths.update(int8_paths)
    log(f"[zoo] seconds per phase: {seconds}")
    by_kernel = {k: {path: got[k] for path, got in paths.items() if got[k]}
                 for k in ("K-A", "K-C drho", "K-C dsigma", "K-F")}
    for k, v in by_kernel.items():
        check(v, f"{k} never ran on the zoo's paths")
    return by_kernel, kf_res

# --- the INT8 remainder: Flipout qresnet50, grouped and transposed convs ----


def build_flipout_qresnet50(calibrate=None, device="cuda", seed=SEED + 40):
    import torch

    from bayesian_torch_tpu_torch.models.bayesian.\
        quantized_resnet_flipout_large import qresnet50

    return qresnet50(generator=torch.Generator().manual_seed(seed),
                     device=device, calibrate=calibrate, fuse_conv_bn=True,
                     quantize_activations=True)


def phase_int8_flipout_build():
    """(37) The calibrated INT8 Flipout model: the float Flipout ResNet-50
    (f32) takes its BN statistics from one training-mode forward
    (observers off), calibrates on 3 batches of 32 images (the Flipout
    calibration forward: mean and perturbation convs, the signs) and is
    converted with conv+BN folding and uint8 activations: 54 quantized
    Flipout layers, each with a 10-slot quant_dict."""
    import torch

    def calibrate(model):
        prepared = [m for m in model.modules()
                    if getattr(m, "quant_prepare", False)]
        for m in prepared:
            m.quant_prepare = False
        set_bn_statistics(model, images(SEED + 520))
        for m in prepared:
            m.quant_prepare = True
        with torch.no_grad():
            for i in range(3):
                model(images(SEED + 530 + i)[:CALIB_BATCH])

    t0 = time.perf_counter()
    model = build_flipout_qresnet50(calibrate)
    torch.cuda.synchronize()
    layers = [m for m in model.modules() if hasattr(m, "quant_dict")]
    check(len(layers) == INT8_LAYERS
          and all(m.estimator == "flipout" and m.quant_dict is not None
                  and len(m.quant_dict) == 10 for m in layers),
          "not every layer of the INT8 Flipout model is a calibrated "
          "Flipout layer")
    log(f"[int8 flipout build] qresnet50 (Flipout) f32 -> BN statistics, "
        f"3 x {CALIB_BATCH} calibration images, convert(fuse_conv_bn=True, "
        f"quantize_activations=True): {time.perf_counter() - t0:.1f} s; "
        f"{len(layers)} quantized Flipout layers")
    return model


def sign_shapes(model, x):
    """The (input, output) shapes of every quantized Flipout layer in one
    forward: the shapes of the two sign tensors each draws."""
    import torch

    layers = [m for m in model.modules() if hasattr(m, "quant_dict")]
    shapes = []
    handles = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(
            (tuple(inp[0].shape), tuple(
                (out[0] if isinstance(out, tuple) else out).shape))))
        for m in layers]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return shapes


def int8_sign_launches(batches, forwards):
    """K-H3's launches in ``batches`` of ``forwards`` INT8 Flipout
    forwards: the input pass, one a layer (the output's signs are K-F's
    Flipout epilogue's)."""
    return {"K-H1": 0, "K-H2": 0, "K-H3": INT8_LAYERS * forwards * batches,
            TORCH_HASHES: 0}


@contextlib.contextmanager
def counting_calls(module, name):
    """``module.name`` wrapped to count its calls (in ``.calls`` of the
    object yielded) for the duration."""
    real = getattr(module, name)

    def counted(*args, **kw):
        counted.calls += 1
        return real(*args, **kw)

    counted.calls = 0
    setattr(module, name, counted)
    try:
        yield counted
    finally:
        setattr(module, name, real)


def phase_int8_flipout_main(model, batches):
    """(38) The INT8 Flipout main path: MC-10 at batch 128 (54 layers, 10
    draws: 540 plain K-F launches a batch, the means, and 540 with the
    Flipout epilogue, the perturbations; 540 K-H3 input passes), three
    batches after a warm-up, peak memory; one batch under the profiler
    (busy time, idle share, K-F's, its epilogue's and K-H3's device time
    and share); frozen perturbations, MC-1; the uncalibrated model's
    MC-10; no torch ``qadd`` in the batches. Returns a dict of the
    results."""
    import torch

    from torch.autograd import DeviceType

    from bayesian_torch_tpu_torch.ops import int8
    from bayesian_torch_tpu_torch.parallel import mc_forward
    from bayesian_torch_tpu_torch.quantization import freeze_quantized_draws

    def mc10(m):
        return lambda x: mc_forward(m, x, NUM_MC, reduce="mean",
                                    return_kl=False)

    per_batch = INT8_LAYERS * NUM_MC
    torch.cuda.reset_peak_memory_stats()
    with counting_calls(int8, "qadd") as qadds:
        ms, outs, launches = timed_batches(
            f"int8 flipout MC-{NUM_MC} bs{BATCH}", mc10(model), batches,
            per_batch, per_batch)
    check(qadds.calls == 0, f"int8 flipout MC-{NUM_MC}: {qadds.calls} torch "
          "qadd calls, want none (K-F's Flipout epilogue adds)")
    kf_flip = counts()["K-F flipout"]
    kh3 = check_signs(f"int8 flipout MC-{NUM_MC}", int8_sign_launches(
        len(batches), NUM_MC))["K-H3"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = profile_window(
        f"one INT8 Flipout MC-{NUM_MC} batch (bs{BATCH})",
        lambda: mc10(model)(batches[0]), rows=15)

    def rows_ms(tag):
        return sum(e.self_device_time_total for e in prof["events"]
                   if e.device_type == DeviceType.CUDA
                   and tag in e.key) / 1e3

    kf_ms, sign_ms = rows_ms("qmatmul"), rows_ms("QSignOp")
    flip_ms = rows_ms(KF_FLIP_TAG)
    busy = prof["busy"]
    res = dict(ms=ms, peak_gib=peak, launches=launches, busy_ms=busy,
               wall_ms=prof["wall"], idle=1 - busy / prof["wall"],
               kf_ms=kf_ms, kf_share=kf_ms / busy, kf_flipout_ms=flip_ms,
               kf_flipout_launches=kf_flip, kh3_launches=kh3,
               sign_ms=sign_ms, sign_share=sign_ms / busy)
    log(f"[int8 flipout main] {card()}: median {ms:.1f} ms/batch, "
        f"{BATCH / ms * 1e3:.1f} images/s, peak {peak:.2f} GiB; profiled "
        f"batch: busy {busy:.1f} of {prof['wall']:.1f} ms (idle "
        f"{res['idle']:.3f}); K-F {kf_ms:.2f} ms ({res['kf_share']:.3f} of "
        f"busy, {2 * per_batch} launches), of it the Flipout epilogue's "
        f"{flip_ms:.2f} ms ({per_batch} launches); K-H3's input passes "
        f"({per_batch} launches) {sign_ms:.2f} ms, {res['sign_share']:.3f} "
        f"of busy; entropy {entropy(outs[0]):.4f}")

    check(freeze_quantized_draws(model) == INT8_LAYERS, "froze the layers")
    with torch.no_grad():
        res["frozen_ms"], _, _ = timed_batches(
            "int8 flipout frozen MC-1", lambda x: model(x)[0], batches,
            INT8_LAYERS, INT8_LAYERS)
    check_signs("int8 flipout frozen MC-1",
                int8_sign_launches(len(batches), 1))
    uncal = build_flipout_qresnet50()
    check(all(m.quant_dict is None for m in uncal.modules()
              if hasattr(m, "quant_dict")), "uncalibrated model has scales")
    res["uncalibrated_ms"], _, uncal_launches = timed_batches(
        f"int8 flipout uncalibrated MC-{NUM_MC}", mc10(uncal), batches,
        per_batch, per_batch)
    check_signs(f"int8 flipout uncalibrated MC-{NUM_MC}",
                int8_sign_launches(len(batches), NUM_MC))
    res["launches_uncalibrated"] = uncal_launches
    res["launches_uncalibrated_flipout"] = counts()["K-F flipout"]
    del uncal
    torch.cuda.empty_cache()
    return res


def phase_int8_flipout_sanity(model, x):
    """(39) With frozen perturbations and every layer's generator
    reseeded (so the signs' salts agree), the card's uint8 activations
    into the average pool and its uint8 logits (the head's QTensor) on 2
    images equal a CPU copy's on the plain versions: the signs come from
    the integer hash and K-F equals its plain version bit for bit. Then
    two forwards with the same frozen perturbations differ (their signs
    are drawn per call)."""
    import torch

    from bayesian_torch_tpu_torch.ops.qtensor import dequantize_if_qtensor
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state

    t0 = time.perf_counter()
    cpu = build_flipout_qresnet50(device="cpu", seed=SEED + 41)
    load_jax_quant_state(
        cpu, {k: v.cpu().numpy() for k, v in model.state_dict().items()},
        {name: m.quant_dict for name, m in model.named_modules()
         if hasattr(m, "quant_dict")})
    pooled = {}

    def run(m, xs):
        for mod in m.modules():
            if hasattr(mod, "quant_dict"):
                mod.generator.manual_seed(SEED + 42)
        m.fc.q_output = True
        h = m.avgpool.register_forward_hook(
            lambda mod, inp, out: pooled.__setitem__(
                xs.device.type, dequantize_if_qtensor(inp[0]).cpu()))
        try:
            with torch.no_grad():
                return m(xs)[0].q.cpu()
        finally:
            h.remove()
            m.fc.q_output = False

    xs = x[:2]
    reset_counts()
    got = run(model, xs)
    check_signs("int8 flipout sanity, the card's forward",
                int8_sign_launches(1, 1))
    check(counts()["K-F flipout"] == INT8_LAYERS, f"int8 flipout sanity: "
          f"{counts()['K-F flipout']} Flipout epilogues, want {INT8_LAYERS}")
    want = run(cpu, xs.cpu())
    pool_equal = torch.equal(pooled["cuda"], pooled["cpu"])
    equal = torch.equal(got, want)
    log(f"[int8 flipout sanity] card vs CPU copy, frozen perturbations, "
        f"generators reseeded, 2 images ({time.perf_counter() - t0:.1f} s):"
        f" activations into the pool equal: {pool_equal}; uint8 "
        f"logits equal: {equal} (max |diff| "
        f"{(got.int() - want.int()).abs().max().item()} quanta)")
    check(pool_equal and equal, "INT8 Flipout: card and CPU copy differ")
    with torch.no_grad():
        a, b = model(x)[0], model(x)[0]
    check(not torch.equal(a, b), "two frozen-perturbation forwards are "
          "equal: the signs did not change")
    log("[int8 flipout sanity] two forwards with frozen perturbations "
        "differ (signs per call)")


@contextlib.contextmanager
def kf_plain_route():
    """``ops.int8``'s GEMMs on K-F's plain versions (the same lowering, the
    same epilogues, the Flipout one too), on the card."""
    from bayesian_torch_tpu_torch.ops import int8
    from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kf

    def plain(x_q, x_scale, x_zp, w_q, w_scale, bias, out_scale, out_zp):
        args = kf.requant_args(w_q, x_zp, x_scale, w_scale, bias, out_scale)
        return kf.qmatmul_requant_plain(x_q, w_q, *args, out_zp)

    def flipout(x_q, x_scale, x_zp, w_q, w_scale, bias, out_scale, out_zp,
                epi):
        args = kf.requant_args(w_q, x_zp, x_scale, w_scale, bias, out_scale)
        return kf.qmatmul_requant_flipout_plain(x_q, w_q, *args, out_zp,
                                                out_scale, epi)

    saved = int8.qmatmul_requant, int8.qmatmul_requant_flipout
    int8.qmatmul_requant, int8.qmatmul_requant_flipout = plain, flipout
    try:
        yield
    finally:
        int8.qmatmul_requant, int8.qmatmul_requant_flipout = saved


def qconv_f64(x_q, x_scale, x_zp, w_q, w_scale, bias, out_scale, out_zp, *,
              transposed=False, **kw):
    """The JAX XLA route's value: the integer sum of w * (x - x_zp) over
    the real taps from a float64 torch conv (exact: |acc| < 2**53; cuDNN
    off, so no transform algorithm rounds it), then the f32 epilogue."""
    import torch
    import torch.nn.functional as F

    from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kf

    conv = F.conv_transpose2d if transposed else F.conv2d
    with torch.backends.cudnn.flags(enabled=False):
        acc = conv(x_q.double() - x_zp, w_q.double(), **kw)
    out = acc.float() * kf.requant_multiplier(x_scale, w_scale, out_scale)
    if bias is not None:
        out = out + (bias.float() * (1.0 / out_scale)).reshape(1, -1, 1, 1)
    return torch.clamp(torch.round(out) + out_zp, 0, 255).to(torch.uint8)


def probe_times(what, route, nbytes, ops, launches_each):
    """Device times of ``route()`` on K-F and on its plain version, K-F's
    own rows, the bound; the launches of one call checked (``launches_each``
    plain K-F launches, or {K-F form: launches})."""
    before = counts()
    route()
    got = {k: counts()[k] - before[k] for k in ("K-F", "K-F flipout")}
    want = launches_each if isinstance(launches_each, dict) else \
        {"K-F": launches_each, "K-F flipout": 0}
    check(got == want, f"{what}: K-F launched {got}, want {want}")

    def plain():
        with kf_plain_route():
            route()

    ms, kf_ms, plain_ms = device_times((route, None), (route, "qmatmul"),
                                       (plain, None))
    bound_ms, by = bound(nbytes, ops, INT8_OPS)
    log(f"[{what}] {card()}: route {ms:.3f} ms device time, of it K-F "
        f"{kf_ms:.3f} ms ({sum(got.values())} launches); plain route "
        f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({by}); library: none "
        f"(no PyTorch int8 grouped or transposed conv)")
    return dict(ms=ms, kf_ms=kf_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=None, launches=got)


def phase_int8_probes():
    """(40) Grouped and transposed int8 convs on the card, bit for bit
    with the plain route (K-F's plain version in the same lowering) and
    with the float64 conv's integer sum: a ResNeXt-like 3x3 conv, 256 ->
    256 channels in 32 groups, at 56x56, batch 32 (``qconv``: 32 K-F
    GEMMs); a DCGAN-like ``QuantizedConvTranspose2dReparameterization``
    and ``QuantizedConvTranspose2dFlipout``, 512 -> 256, k4 s2 p1, at
    16x16, batch 64 (calibrated, frozen draws, the Flipout layer's signs
    from reseeded generators); the grouped conv again with the Flipout
    epilogue. Returns ({path: {K-F form: launches}}, results)."""
    import torch
    from torch import nn

    from bayesian_torch_tpu_torch import layers as L
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn
    from bayesian_torch_tpu_torch.ops import int8
    from bayesian_torch_tpu_torch.ops import sampling as ts
    from bayesian_torch_tpu_torch.ops.cuda.flipout_signs import OutputSigns
    from bayesian_torch_tpu_torch.quantization import (freeze_quantized_draws,
                                                       prepare)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 800)
    results, paths = {}, {}

    # ResNeXt-like grouped conv
    B, C, H, G = 32, 256, 56, 32
    x = torch.randint(0, 256, (B, C, H, H), dtype=torch.uint8, device="cuda",
                      generator=gen)
    w = torch.randint(-128, 128, (C, C // G, 3, 3), dtype=torch.int8,
                      device="cuda", generator=gen)
    b = torch.randn(C, device="cuda", generator=gen)
    args = (0.02, 117, w, 0.01, b, 0.02 * 0.01 * 74 * 74 * 72 ** 0.5 / 40,
            128)
    kw = dict(stride=1, padding=1, groups=G)
    got = int8.qconv(x, *args, **kw)
    with kf_plain_route():
        plain = int8.qconv(x, *args, **kw)
    ref = qconv_f64(x, *args, **kw)
    check(torch.equal(got, plain) and torch.equal(got, ref),
          "grouped qconv: K-F route, plain route and f64 conv differ")
    reset_counts()
    results["resnext"] = probe_times(
        f"int8 grouped probe {C}->{C} g{G} 3x3 {H}^2 bs{B}",
        lambda: int8.qconv(x, *args, **kw),
        x.numel() + w.numel() + got.numel() + 4 * C,
        2 * B * H * H * C * (C // G) * 9, G)
    paths["grouped probe"] = results["resnext"]["launches"]
    log(f"[int8 grouped probe] bit for bit with the plain route and the "
        f"f64 conv; clamped share "
        f"{((got == 0) | (got == 255)).float().mean().item():.4f}")
    # the same conv as a Flipout layer's perturbation, the probe's output
    # its mean: each group's GEMM takes its columns of the mean and its
    # block of the signs through K-F's Flipout epilogue
    sc = args[5]
    epi = int8.FlipoutEpilogue(
        got, sc, 128.0, OutputSigns(ts.sign_block(
            [ts.sign_salts(SEED + 803)[1]], tuple(got.shape)), 1),
        0.0079, 127.0, sc, 124.0, 1.4 * sc, 126.0)
    flip = int8.qconv(x, *args, flipout=epi, **kw)
    with kf_plain_route():
        plain = int8.qconv(x, *args, flipout=epi, **kw)
    check(torch.equal(flip, plain), "grouped qconv with the Flipout "
          "epilogue: K-F route and plain route differ")
    check(not torch.equal(flip, got), "the Flipout epilogue left the mean")
    results["resnext flipout"] = probe_times(
        f"int8 grouped probe {C}->{C} g{G} 3x3 {H}^2 bs{B}, Flipout "
        f"epilogue", lambda: int8.qconv(x, *args, flipout=epi, **kw),
        x.numel() + w.numel() + 2 * got.numel() + 4 * C,
        2 * B * H * H * C * (C // G) * 9, {"K-F": 0, "K-F flipout": G})
    paths["grouped probe, Flipout epilogue"] = \
        results["resnext flipout"]["launches"]
    log("[int8 grouped probe] with the Flipout epilogue: bit for bit with "
        "the plain route")
    del x, w, got, plain, ref, flip, epi

    # DCGAN-like transposed layers
    B, I, O, H = 64, 512, 256, 16
    for est in ("Reparameterization", "Flipout"):
        float_layer = getattr(L, f"ConvTranspose2d{est}")(
            I, O, 4, 2, 1, generator=torch.Generator().manual_seed(SEED + 801),
            device="cuda")
        holder = nn.ModuleDict(dict(l=float_layer)).eval()
        prepare(holder)
        xf = torch.randn(B, I, H, H, device="cuda", generator=gen)
        with torch.no_grad():
            holder["l"](xf)
        bnn_to_qbnn(holder)
        layer = holder["l"]
        check(type(layer).__name__ == f"QuantizedConvTranspose2d{est}"
              and len(layer.quant_dict) == (10 if est == "Flipout" else 5),
              f"{est}: the calibrated quantized twin")
        freeze_quantized_draws(holder)
        x = torch.randn(B, I, H, H, device="cuda", generator=gen)

        def fwd():
            layer.generator.manual_seed(SEED + 802)
            with torch.no_grad():
                out = layer(x, return_kl=False)
            return out

        layer.q_output = True
        got = fwd().q
        with kf_plain_route():
            plain = fwd().q
        check(torch.equal(got, plain), f"transposed {est}: the K-F route "
              "and the plain route differ")
        # the mean conv's integer sum against the f64 conv transpose
        s2, z2 = layer._qd(2 if est == "Flipout" else 3)
        s3, z3 = layer._qd(3 if est == "Flipout" else 4)
        x_q = layer._quantize_input(x, s2, z2)
        w_q = layer.quantized_mu_weight if est == "Flipout" \
            else layer._frozen_w
        w_s = layer._mu_scale_f if est == "Flipout" \
            else layer._frozen_wscale_f
        bias = layer.quantized_mu_bias if est == "Flipout" \
            else layer._frozen_bias
        tkw = dict(stride=2, padding=1)
        mean = int8.qconv(x_q, s2, z2, w_q, w_s, bias, s3, z3,
                          transposed=True, **tkw)
        check(torch.equal(mean, qconv_f64(x_q, s2, z2, w_q, w_s, bias, s3,
                                          z3, transposed=True, **tkw)),
              f"transposed {est}: qconv and the f64 conv differ")
        n = 2 if est == "Flipout" else 1
        reset_counts()
        res = probe_times(
            f"int8 transposed probe {est} {I}->{O} k4s2p1 {H}^2 bs{B}",
            fwd, x.numel() * 4 + n * w_q.numel() + got.numel() + 4 * O,
            n * 2 * B * H * H * I * O * 16,
            {"K-F": 1, "K-F flipout": n - 1})
        results[f"convtranspose {est}"] = res
        paths[f"transposed probe {est}"] = res["launches"]
        log(f"[int8 transposed probe {est}] bit for bit with the plain route"
            f" (frozen draws, reseeded signs) and, for the mean product, the "
            f"f64 conv transpose")
        del layer, holder, float_layer, x, got, plain
        torch.cuda.empty_cache()
    return paths, results


def phase_int8_remainder():
    """Phases 37-40, each one's seconds logged. Returns ({K-F form: {path:
    launches}}, the Flipout main path's results, the probes' results)."""
    import torch

    seconds = {}
    t0 = time.perf_counter()
    model = phase_int8_flipout_build()
    batches = [images(SEED + 1 + i) for i in range(3)]
    seconds["build"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    main_res = phase_int8_flipout_main(model, batches)
    seconds["main"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    phase_int8_flipout_sanity(model, batches[0])
    seconds["sanity"] = round(time.perf_counter() - t0, 1)
    del model, batches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths, probes = phase_int8_probes()
    seconds["probes"] = round(time.perf_counter() - t0, 1)
    batch_paths = {
        f"int8 flipout MC-{NUM_MC} bs{BATCH} batches": {
            "K-F": main_res["launches"],
            "K-F flipout": main_res["kf_flipout_launches"]},
        f"int8 flipout uncalibrated MC-{NUM_MC} batches": {
            "K-F": main_res["launches_uncalibrated"],
            "K-F flipout": main_res["launches_uncalibrated_flipout"]}}
    paths = {k: {path: got[k] for path, got in {**batch_paths,
                                                **paths}.items() if got[k]}
             for k in ("K-F", "K-F flipout")}
    log(f"[int8 remainder] seconds per phase: {seconds}")
    return paths, main_res, probes


# --- the Bayesian LSTM: config #4 at full width (phase 41) -----------------

LSTM_BATCH = 128
LSTM_SEQ = 64
LSTM_HIDDEN = 64
LSTM_MC = 20
LSTM_STEPS = 40  # the trainer's steps at batch 128
LSTM_TIMED = 5  # timed MC-20 batches a path: the loop's host time varies
# the launches of one forward's LSTM draws (ih W, ih b, hh W, hh b)
LSTM_TENSORS = 4


def lstm_model(estimator, seed, device="cuda"):
    """The trainer's regressor (LSTM(1 -> 64) + Linear(64 -> 2)), f32."""
    import torch

    from bayesian_torch_tpu_torch.examples.main_bayesian_lstm_timeseries \
        import BayesianLSTMRegressor
    return BayesianLSTMRegressor(
        LSTM_HIDDEN, estimator, generator=torch.Generator().manual_seed(seed),
        device=device)


def lstm_windows(seed):
    """A (128, 64, 1) batch of the trainer's series windows and targets."""
    import numpy as np
    import torch

    from bayesian_torch_tpu_torch.examples.main_bayesian_lstm_timeseries \
        import make_series, windows
    x, y = windows(make_series(), LSTM_SEQ, LSTM_BATCH,
                   np.random.RandomState(seed))
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def lstm_kernel_checks():
    """(a) K-A and K-C (dsigma) at the LSTM's draw buffers: the ih weight
    (256 x 1), the hh weight (256 x 64) and a bias (256), with T = 64
    lanes (one forward) and S*T = 1280 (MC-20 under the draw axis), f32,
    against their plain versions. Returns the largest errors."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    h4 = 4 * LSTM_HIDDEN
    shapes = {"ih W": (h4, 1), "hh W": (h4, LSTM_HIDDEN), "bias": (h4,)}
    worst = dict(sample=0.0, dsigma=0.0)
    for lanes in (LSTM_SEQ, LSTM_MC * LSTM_SEQ):
        for i, (name, shape) in enumerate(shapes.items()):
            gen = torch.Generator().manual_seed(lanes + i)
            mu = (0.3 * torch.randn(shape, generator=gen)).cuda()
            sigma = sigma_from_rho(torch.randn(shape, generator=gen)
                                   - 3.0).cuda()
            g = torch.randn((lanes,) + shape, generator=gen).cuda()
            seed = 0x5EED_0000_0000_0400 + lanes + i
            e_a = max_err(
                ka.sample_scaled_normals_batch(seed, mu, sigma, lanes,
                                               torch.float32),
                ka.sample_scaled_normals_batch_plain(seed, mu, sigma, lanes,
                                                     torch.float32))
            want = ka.dsigma_plain(seed, g)
            e_c = max_err(ka.dsigma(seed, g), want) / max(
                1.0, want.abs().max().item())
            log(f"[lstm kernels] {name} {tuple(shape)}, {lanes} lanes: K-A "
                f"max|kernel-plain| {e_a:.3e} (limit 1e-5), K-C dsigma "
                f"{e_c:.3e} x max(1, max|plain|) (limit 1e-5)")
            check(e_a <= 1e-5 and e_c <= 1e-5,
                  f"K-A or K-C off its plain version at the LSTM's {name}, "
                  f"{lanes} lanes")
            worst["sample"] = max(worst["sample"], e_a)
            worst["dsigma"] = max(worst["dsigma"], e_c)
    return worst


def lstm_card_vs_cpu(estimator):
    """(b) One forward of the regressor on the card and of a CPU copy on
    the plain versions, the generators reseeded alike (the same seeds, the
    counter hash the same noise), f32 with TF32 off: outputs and KL within
    1e-4 x max(1, max|CPU|)."""
    import copy

    import torch

    card = lstm_model(estimator, SEED + 900)
    cpu = copy.deepcopy(card).cpu()
    x, _ = lstm_windows(SEED + 901)
    outs = []
    with tf32_off(), torch.no_grad():
        for model, xs in ((card, x), (cpu, x.cpu())):
            model.lstm.generator.manual_seed(SEED + 902)
            outs.append(model(xs))
    (got, got_kl), (want, want_kl) = outs
    scale = max(1.0, want.abs().max().item())
    err = max_err(got.cpu(), want) / scale
    kl_err = abs(got_kl.item() - want_kl.item()) / max(1.0, want_kl.item())
    log(f"[lstm card vs cpu] {estimator}: bs{LSTM_BATCH} seq{LSTM_SEQ} "
        f"hidden{LSTM_HIDDEN}: max|card-cpu| {err:.3e} x max(1, max|cpu|) "
        f"(limit 1e-4), KL {kl_err:.2e} relative")
    check(err <= 1e-4 and kl_err <= 1e-5,
          f"LSTM {estimator}: the card disagrees with its CPU copy")
    return err


def lstm_sigma_zero(estimator):
    """(c) At rho = -30 the Bayesian LSTM equals ``torch.nn.LSTM``
    (batch-first) holding ``weight_ih = ih.mu_weight`` and the matching
    ``hh`` and biases, within 1e-5, f32 with TF32 off (an independent
    implementation: cuDNN's)."""
    import torch

    import bayesian_torch_tpu_torch.layers as L

    lstm = getattr(L, "LSTM" + estimator)(
        1, LSTM_HIDDEN, generator=torch.Generator().manual_seed(SEED + 910),
        device="cuda")
    ref = torch.nn.LSTM(1, LSTM_HIDDEN, batch_first=True).cuda()
    with torch.no_grad():
        for block in ("ih", "hh"):
            lin = getattr(lstm, block)
            lin.rho_weight.fill_(-30.0)
            lin.rho_bias.fill_(-30.0)
            getattr(ref, f"weight_{block}_l0").copy_(lin.mu_weight)
            getattr(ref, f"bias_{block}_l0").copy_(lin.mu_bias)
    x, _ = lstm_windows(SEED + 911)
    with tf32_off(), torch.no_grad():
        got, (_, got_c), _ = lstm(x)
        want, _ = ref(x)
    err = max_err(got, want)
    log(f"[lstm sigma zero] {estimator} at rho = -30 against torch.nn.LSTM: "
        f"max|diff| {err:.3e} (limit 1e-5)")
    check(err <= 1e-5, f"LSTM {estimator} at rho = -30 is not torch's LSTM")
    return err


def lstm_inference(what, model, x, emission, want, signs=None):
    """(d) MC-20 bs128 through ``mc_forward(emission=...)``: a warm-up,
    LSTM_TIMED timed batches (host clock to synchronize; median and
    spread), each batch's launches equal to ``want`` (and the K-H
    launches to ``signs``, where given); one batch under the
    profiler for the busy time. The idle share is 1 - busy / the
    unprofiled median; the profiled batch's own share, whose wall time
    also holds the profiler's host overhead, is logged beside it.
    Returns (results, one batch's launches)."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    def run():
        return mc_forward(model, x, LSTM_MC, emission=emission,
                          return_kl=False)

    run()
    torch.cuda.synchronize()
    times = []
    for i in range(LSTM_TIMED):
        reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        check(tuple(out.shape) == (LSTM_MC, LSTM_BATCH, LSTM_SEQ, 2)
              and bool(torch.isfinite(out).all()),
              f"{what}: output {tuple(out.shape)} or not finite")
        check(got == want, f"{what} batch {i}: launches {nonzero(got)}, "
              f"want {nonzero(want)}")
        if signs is not None:
            got_signs = check_signs(f"{what} batch {i}", signs)
    ms = statistics.median(times)
    prof = profile_window(f"{what}: one MC-{LSTM_MC} bs{LSTM_BATCH} batch",
                          run, rows=8)
    res = dict(ms=ms, ms_min=min(times), ms_max=max(times),
               busy_ms=prof["busy"], wall_ms=prof["wall"],
               idle=max(0.0, 1 - prof["busy"] / ms),
               idle_profiled=1 - prof["busy"] / prof["wall"],
               ka_per_batch=want["K-A"])
    log(f"[{what}] {card()}: batches {', '.join(f'{t:.1f}' for t in times)}"
        f" ms, median {ms:.2f} ms/batch (min {res['ms_min']:.2f}, max "
        f"{res['ms_max']:.2f}); busy {res['busy_ms']:.2f} ms, idle "
        f"{res['idle']:.3f} of the median (the profiled batch: "
        f"{res['wall_ms']:.2f} ms, idle {res['idle_profiled']:.3f}); "
        f"launches per batch {nonzero(want)}")
    if signs is not None:
        res["signs_per_batch"] = got_signs
    return res, got


def lstm_trainer(estimator, tmp):
    """(f) ``main_bayesian_lstm_timeseries`` at batch 128 for LSTM_STEPS
    steps, then ``--mode=test`` from its checkpoint; the loss falls, the
    launches are exact (a step: K-A 4 for the LSTM's lanes and 2 for the
    head's single draws, K-C dsigma 4, K-C drho 2; the MC-20 evaluation:
    K-A 1 for the head's presample and 4 a draw). Returns
    ({path: launches}, results)."""
    import io
    import re

    from bayesian_torch_tpu_torch.examples import (
        main_bayesian_lstm_timeseries as trainer,
    )

    argv = [f"--estimator={estimator}", f"--batch-size={LSTM_BATCH}",
            f"--seq-len={LSTM_SEQ}", f"--hidden={LSTM_HIDDEN}",
            f"--num_monte_carlo={LSTM_MC}", "--device=cuda",
            f"--save_dir={tmp}"]
    evaluation = 1 + LSTM_TENSORS * LSTM_MC
    none = dict.fromkeys(kernel_counters(), 0)
    paths, res = {}, {}
    for mode, want in (
            ("train", dict(none, **{
                "K-A": (LSTM_TENSORS + 2) * LSTM_STEPS + evaluation,
                "K-C dsigma": LSTM_TENSORS * LSTM_STEPS,
                "K-C drho": 2 * LSTM_STEPS})),
            ("test", dict(none, **{"K-A": evaluation}))):
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rmse = trainer.main(argv + [f"--mode={mode}",
                                        f"--steps={LSTM_STEPS}"])
        secs = time.perf_counter() - t0
        got = counts()
        text = out.getvalue()
        cover = re.search(r"2-sigma coverage ([\d.]+)%", text)
        check(cover is not None and math.isfinite(rmse),
              f"lstm trainer {mode}: no RMSE or coverage in {text!r}")
        check(got == want, f"lstm trainer {mode}: launches {nonzero(got)}, "
              f"want {nonzero(want)}")
        res[f"{mode}_rmse"] = rmse
        res[f"{mode}_coverage"] = float(cover.group(1)) / 100
        res[f"{mode}_s"] = secs
        if mode == "train":
            losses = [float(v) for v in
                      re.findall(r"step \d+: nll\+kl ([-\d.]+)", text)]
            check(len(losses) >= 2 and losses[-1] < losses[0],
                  f"lstm trainer: the loss did not fall: {losses}")
            res["losses"] = losses
        log(f"[lstm trainer] {estimator} --mode={mode}: {secs:.1f} s, "
            f"launches {nonzero(got)}; "
            + (f"loss {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}; "
               if mode == "train" else "")
            + f"test RMSE {rmse:.4f}, 2-sigma coverage "
              f"{res[f'{mode}_coverage']:.3f}")
        paths[f"lstm {estimator} trainer --mode={mode}"] = got
    return paths, res


def lstm_script(tmp):
    """(g) One launch script end to end: ``train_flipout_mnist.sh`` (the
    heredoc that swaps in the Flipout SCNN) at its smallest synthetic
    overrides, in a process of its own."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    script = root / "bayesian_torch_tpu_torch" / "scripts" / \
        "train_flipout_mnist.sh"
    # the script runs ``python3``: the one on PATH first is this one's
    path = os.pathsep.join(
        [os.path.dirname(sys.executable), os.environ.get("PATH", "")])
    env = dict(os.environ, PATH=path, BTT_SYNTH_TRAIN_N="256",
               BTT_SYNTH_TEST_N="128")
    t0 = time.perf_counter()
    proc = subprocess.run(
        ["bash", str(script), "--synthetic", "--epochs=1", "--device=cuda",
         "--test-batch-size=128", "--num_monte_carlo=2",
         f"--save_dir={tmp}/script"], cwd=tmp, env=env, capture_output=True,
        text=True, timeout=600)
    secs = time.perf_counter() - t0
    tail = " | ".join(proc.stdout.strip().splitlines()[-2:])
    log(f"[lstm script] {script.name} --synthetic --epochs=1 (256 train, "
        f"128 test images): rc {proc.returncode}, {secs:.1f} s; last lines: "
        f"{tail}")
    check(proc.returncode == 0 and "test: accuracy" in proc.stdout,
          f"{script.name} failed: {proc.stderr[-2000:]}")
    return secs


def phase_lstm():
    """Phase 41: the Bayesian LSTM at config #4's full width (bs128, seq
    64, hidden 64, f32; the trainer's regressor LSTM(1 -> 64) + Linear(64
    -> 2)), its seconds logged per part. Returns ({kernel: {path:
    launches}} for K-A, K-C dsigma and K-C drho, results)."""
    import tempfile

    import torch

    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn

    seconds, paths, res = {}, {}, {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    res["kernels"] = timed("kernels", lstm_kernel_checks)
    for est in ESTIMATORS:
        res[f"{est} card_vs_cpu"] = timed(f"{est} card vs cpu",
                                          lstm_card_vs_cpu, est)
        res[f"{est} sigma_zero"] = timed(f"{est} sigma zero",
                                         lstm_sigma_zero, est)
    x, _ = lstm_windows(SEED + 920)
    none = dict.fromkeys(kernel_counters(), 0)
    for est in ESTIMATORS:
        model = lstm_model(est, SEED + 921).eval()
        # the loop: the head's presample (1) and the LSTM's 4 a draw; the
        # draw axis: the head's S draws (1) and the LSTM's S*T lanes (4)
        for emission, ka_launches in (
                ("scan", 1 + LSTM_TENSORS * LSTM_MC),
                ("vmap", 1 + LSTM_TENSORS)):
            what = f"lstm {est} MC-{LSTM_MC} {emission}"
            res[what], paths[what] = timed(
                what, lstm_inference, what, model, x, emission,
                dict(none, **{"K-A": ka_launches}), expected_sign_launches(
                    model, LSTM_MC, vmap=emission == "vmap"))
        ratio = res[f"lstm {est} MC-{LSTM_MC} scan"]["ms"] / \
            res[f"lstm {est} MC-{LSTM_MC} vmap"]["ms"]
        log(f"[lstm] {est}: the loop takes {ratio:.2f}x the vmap "
            f"emission's wall time per MC-{LSTM_MC} batch")
    qmodel = lstm_model("Reparameterization", SEED + 922).eval()
    bnn_to_qbnn(qmodel)
    what = f"lstm quantized MC-{LSTM_MC} scan"
    # the quantized cell runs in torch; the head's int8 GEMM is K-F
    res[what], _ = timed(what, lstm_inference, what, qmodel, x, "auto",
                         dict(none, **{"K-F": LSTM_MC}))
    del qmodel
    with tempfile.TemporaryDirectory() as tmp:
        for est in ESTIMATORS:
            got, res[f"{est} trainer"] = timed(f"{est} trainer",
                                               lstm_trainer, est, tmp)
            paths.update(got)
        res["script_s"] = timed("script", lstm_script, tmp)
    torch.cuda.empty_cache()
    log(f"[lstm] seconds per part: {seconds}")
    by_kernel = {k: {path: got[k] for path, got in paths.items() if got[k]}
                 for k in ("K-A", "K-C drho", "K-C dsigma")}
    for k, v in by_kernel.items():
        check(v, f"{k} never ran on the LSTM's paths")
    return by_kernel, res


# --- phase 42: the modes of the last slice ------------------------------------

MODES_LSTM_TIMED = 5  # interleaved loop and draw-axis batches of each
REMAT_MODES = (False, True, "conv_out")


def remat_step(model, remat_blocks, emission, state, gen_state, x, y):
    """One MC-4 ELBO loss and backward (``make_train_step``'s loss, no
    update) of ``model`` from ``state`` and the generator at ``gen_state``,
    with ``remat_blocks`` set: (loss, {name: grad}, running statistics,
    peak GiB of the step)."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    model.load_state_dict(state)
    model.conv1.generator.set_state(gen_state)
    model.remat_blocks = remat_blocks
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, kl = mc_forward(model, x, TRAIN_MC, emission=emission)
    log_probs = torch.log_softmax(outs.float(), dim=-1)
    nll = -log_probs.mean(dim=0).gather(1, y.long()[:, None]).mean()
    loss = nll + kl / BATCH
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var",
                            "num_batches_tracked"))}
    return loss.detach(), grads, stats, peak


def remat_gates(model, emission, x, y):
    """(a) The remat steps against the step without remat, from one state
    and one generator state: loss, every gradient and the running
    statistics within 2^-6 of each tensor's largest value (bf16; cuDNN's
    backward may add in another order), ``num_batches_tracked`` exact, and
    the peak memory of each mode. Returns {mode: peak GiB}."""
    import torch

    state = {k: v.clone() for k, v in model.state_dict().items()}
    gen_state = model.conv1.generator.get_state()
    runs = {mode: remat_step(model, mode, emission, state, gen_state, x, y)
            for mode in REMAT_MODES}
    model.load_state_dict(state)
    model.remat_blocks = False
    want = runs[False]
    worst = {}
    for mode in REMAT_MODES[1:]:
        got = runs[mode]
        loss_diff = abs(float(got[0]) - float(want[0]))
        check(loss_diff <= 2**-6 * abs(float(want[0])),
              f"remat {mode!r} {emission}: loss {float(got[0])} against "
              f"{float(want[0])}")
        ratio = 0.0
        for part, name in ((1, "gradient"), (2, "running statistic")):
            for k, w in want[part].items():
                if k.endswith("num_batches_tracked"):
                    check(torch.equal(got[part][k], w), f"remat {mode!r} "
                          f"{emission}: {k} {got[part][k]} against {w}")
                    continue
                diff, scale = max_err(got[part][k], w), \
                    w.float().abs().max().item()
                check(diff <= 2**-6 * scale, f"remat {mode!r} {emission}: "
                      f"{name} {k} off by {diff:.3e} (max {scale:.3e})")
                ratio = max(ratio, diff / max(scale, 1e-30))
        worst[mode] = (loss_diff, ratio)
    peaks = {mode: runs[mode][3] for mode in REMAT_MODES}
    log(f"[remat] {emission}: MC-{TRAIN_MC} bs{BATCH} {IMAGE}^2 bf16 from "
        f"one state and generator: loss {float(want[0]):.5f}; against no "
        f"remat, |loss diff| and worst max|diff| / max|tensor| over the "
        f"{len(want[1])} gradients and the running statistics: "
        + ", ".join(f"{m!r} {d:.3e}, {r:.3e}" for m, (d, r) in worst.items())
        + f" (limit 2^-6 = {2**-6:.3e}); peak memory of the step: "
        + ", ".join(f"{m!r} {p:.2f} GiB" for m, p in peaks.items())
        + f"; {card()}")
    for mode in REMAT_MODES[1:]:
        check(peaks[mode] < peaks[False], f"remat {mode!r} {emission}: peak "
              f"{peaks[mode]:.2f} GiB, not below {peaks[False]:.2f} GiB")
    return peaks


def remat_timed(model, emission):
    """Three timed MC-4 bs128 steps (``make_train_step``, SGD) after a
    warm-up for each remat mode, launches gated per step
    (``expected_remat_launches``). Returns ({mode: median ms},
    {mode: launches of its three steps})."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step

    vmap = emission == "vmap"
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(TRAIN_MC, BATCH, emission=emission)
    ms, launches = {}, {}
    for mode in REMAT_MODES:
        model.remat_blocks = mode
        step(model, opt, images(SEED + 700), labels(SEED + 700))
        torch.cuda.synchronize()
        want = (expected_remat_launches(model, TRAIN_MC, vmap) if mode
                else expected_vmap_launches(model, training=True) if vmap
                else expected_step_launches(model, TRAIN_MC))
        reset_counts()
        times = []
        for i in range(3):
            before = counts()
            t0 = time.perf_counter()
            loss, _, _ = step(model, opt, images(SEED + 701 + i),
                              labels(SEED + 701 + i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = {k: v - before[k] for k, v in counts().items()}
            check(math.isfinite(float(loss)), f"remat {mode!r} {emission} "
                  f"step {i}: loss {float(loss)}")
            check(got == want, f"remat {mode!r} {emission} step {i}: "
                  f"launches {nonzero(got)}, want {nonzero(want)}")
        check_grads(model, f"remat {mode!r} {emission}")
        ms[mode] = statistics.median(times)
        launches[mode] = counts()
        log(f"[remat] {emission}, remat_blocks={mode!r}: steps "
            f"{', '.join(f'{t:.1f}' for t in times)} ms, median "
            f"{ms[mode]:.1f} ms/step, {BATCH / ms[mode] * 1e3:.1f} images/s;"
            f" launches per step {nonzero(want)}")
    model.remat_blocks = False
    return ms, launches


def remat_profile(model):
    """(f) One vmap remat step under ``utils.profiling.trace``, and
    ``summarize_trace``'s table of its device rows."""
    import shutil
    import tempfile

    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step
    from bayesian_torch_tpu_torch.utils.profiling import (summarize_trace,
                                                          trace)

    model.remat_blocks = True
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(TRAIN_MC, BATCH, emission="vmap")
    logdir = tempfile.mkdtemp(prefix="remat_trace_")
    try:
        with trace(logdir):
            step(model, opt, images(SEED + 710), labels(SEED + 710))
            torch.cuda.synchronize()
        rows = summarize_trace(logdir, top=12)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
        model.remat_blocks = False
    check(rows, "summarize_trace found no device rows in the remat step")
    total = sum(ms for _, ms in rows)
    log(f"[remat profile] one vmap MC-{TRAIN_MC} bs{BATCH} remat_blocks=True"
        f" step under utils.profiling.trace, summarize_trace's top "
        f"{len(rows)} device rows ({total:.1f} ms together), {card()}:\n"
        + "\n".join(f"  {ms:10.3f} ms  {name[:90]}" for name, ms in rows))
    return rows


def structured_check(model):
    """(b) ``structured=True`` at MC-10 bs128 (eval, bf16) equals the vmap
    emission exactly with the generator rewound; both timed once."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    x = images(SEED + 720)
    out, ms = {}, {}
    for name, kw in (("vmap", dict(emission="vmap")),
                     ("structured", dict(structured=True))):
        same_seeds(model, lambda: mc_forward(model, x, NUM_MC,
                                             return_kl=False, **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = same_seeds(model, lambda: mc_forward(
            model, x, NUM_MC, return_kl=False, **kw))
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    check(tuple(out["structured"].shape) == (NUM_MC, BATCH, 1000)
          and bool(torch.isfinite(out["structured"]).all()),
          "structured: output")
    check(torch.equal(out["structured"], out["vmap"]),
          "structured=True differs from emission='vmap' on the same seeds")
    log(f"[structured] MC-{NUM_MC} bs{BATCH} bf16 eval: structured=True "
        f"equals emission='vmap' exactly on the same seeds; one batch each "
        f"{ms['structured']:.1f} / {ms['vmap']:.1f} ms; {card()}")
    return ms


def int8_draw_axis(what, model, per_draw):
    """(c) An INT8 qresnet50's MC-10 bs128 batch through the loop and under
    the draw axis on the same presample record (the generator rewound):
    lane for lane equal, ``per_draw`` ({K-F form: launches a draw}) x 10
    launches each way; one warm-up and one timed batch each. Returns the
    times and launches."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    x = images(SEED + 730)
    res, outs = {}, {}
    for emission in ("scan", "vmap"):
        def run():
            return same_seeds(model, lambda: mc_forward(
                model, x, NUM_MC, presample="on", return_kl=False,
                emission=emission))
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        outs[emission] = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        kf_launches = {k: counts()[k] for k in per_draw}
        want = {k: n * NUM_MC for k, n in per_draw.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        res[emission] = dict(ms=ms, launches=kf_launches, peak_gib=peak)
        check(kf_launches == want, f"{what} {emission}: K-F launched "
              f"{kf_launches}, want {want}")
        log(f"[{what}] {emission}: {ms:.1f} ms for one MC-{NUM_MC} "
            f"bs{BATCH} batch, K-F {kf_launches}, peak {peak:.2f} GiB")
    a, b = outs["vmap"], outs["scan"]
    check(tuple(a.shape) == (NUM_MC, BATCH, 1000)
          and bool(torch.isfinite(a).all()), f"{what}: draw-axis output")
    check(torch.equal(a, b), f"{what}: the draw axis differs from the loop "
          f"(max |diff| {max_err(a, b):.3e})")
    log(f"[{what}] draw axis lane for lane equal to the loop on the same "
        f"record ({NUM_MC} lanes, bit for bit); {card()}")
    return res


def quantized_lstm_interleaved():
    """(d) The quantized LSTM regressor (``bnn_to_qbnn``) at config #4:
    MODES_LSTM_TIMED MC-20 bs128 batches through the loop and under the
    draw axis, interleaved, K-F (the head) 20 a batch each way; one
    profiled batch of each for busy time and idle share."""
    import torch

    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn
    from bayesian_torch_tpu_torch.parallel import mc_forward

    model = lstm_model("Reparameterization", SEED + 740).eval()
    bnn_to_qbnn(model)
    x, _ = lstm_windows(SEED + 741)

    def run(emission):
        return mc_forward(model, x, LSTM_MC, emission=emission,
                          return_kl=False)

    times = {"scan": [], "vmap": []}
    for emission in times:
        run(emission)
    torch.cuda.synchronize()
    for i in range(MODES_LSTM_TIMED):
        for emission in times:
            reset_counts()
            t0 = time.perf_counter()
            out = run(emission)
            torch.cuda.synchronize()
            times[emission].append((time.perf_counter() - t0) * 1e3)
            check(tuple(out.shape) == (LSTM_MC, LSTM_BATCH, LSTM_SEQ, 2)
                  and bool(torch.isfinite(out).all()),
                  f"quantized lstm {emission}: output")
            check(counts()["K-F"] == LSTM_MC, f"quantized lstm {emission} "
                  f"batch {i}: K-F {counts()['K-F']}, want {LSTM_MC}")
    res = {}
    for emission, t in times.items():
        ms = statistics.median(t)
        prof = profile_window(f"quantized lstm {emission}: one MC-{LSTM_MC} "
                              f"bs{LSTM_BATCH} batch",
                              lambda: run(emission), rows=6)
        res[emission] = dict(ms=ms, ms_min=min(t), ms_max=max(t),
                             busy_ms=prof["busy"],
                             idle=max(0.0, 1 - prof["busy"] / ms))
        log(f"[quantized lstm] {emission}, {card()}: batches "
            f"{', '.join(f'{v:.1f}' for v in t)} ms, median {ms:.2f} "
            f"(min {min(t):.2f}, max {max(t):.2f}); busy "
            f"{prof['busy']:.2f} ms, idle {res[emission]['idle']:.3f} of "
            f"the median; K-F {LSTM_MC} a batch")
    log(f"[quantized lstm] the loop takes "
        f"{res['scan']['ms'] / res['vmap']['ms']:.2f}x the draw axis's wall "
        f"time (medians of {MODES_LSTM_TIMED} interleaved batches)")
    return res


def modes_trainer():
    """(e) ``main_bayesian_imagenet --remat --structured-mc --synthetic
    --batch-size=32 --epochs=1``: every step K-A 107 (55 draws and the
    blocks' 52 again) and K-C drho 55, its MC-10 evaluation through the
    draw axis (54 K-A a batch); the accuracy in [0, 1]."""
    import io
    import tempfile

    from bayesian_torch_tpu_torch.examples import main_bayesian_imagenet
    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large \
        import resnet50

    probe = resnet50(device="meta")
    per_step = expected_remat_launches(probe, 1, vmap=False)
    per_eval = expected_vmap_launches(probe, training=False)["K-A"]
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            metrics = main_bayesian_imagenet.main([
                "--remat", "--structured-mc", "--synthetic",
                f"--batch-size={TRAINER_BATCH}", "--epochs=1",
                f"--save_dir={tmp}"])
        seconds = time.perf_counter() - t0
        got = counts()
    steps = got["K-C drho"] // per_step["K-C drho"]
    evals = (got["K-A"] - steps * per_step["K-A"]) // max(per_eval, 1)
    check(steps > 0 and got["K-C drho"] == steps * per_step["K-C drho"],
          f"trainer --remat: K-C drho {got['K-C drho']}")
    check(evals > 0 and got["K-A"] == steps * per_step["K-A"]
          + evals * per_eval, f"trainer --remat: K-A {got['K-A']} for "
          f"{steps} steps and {evals} evaluation batches")
    check(0.0 <= metrics["accuracy"] <= 1.0, f"trainer: {metrics}")
    log(f"[modes trainer] --remat --structured-mc --epochs=1 "
        f"--batch-size={TRAINER_BATCH}: {seconds:.1f} s, {steps} steps "
        f"(K-A {per_step['K-A']} and K-C drho {per_step['K-C drho']} each), "
        f"{evals} structured MC-10 evaluation batch(es) ({per_eval} K-A "
        f"each), accuracy {metrics['accuracy']:.4f}; last lines: "
        + " | ".join(out.getvalue().strip().splitlines()[-2:]))
    return nonzero(got)


def phase_modes():
    """Phase 42: block remat with replayed draws, structured=True, INT8
    models under the draw axis, the trainer's --remat and --structured-mc
    and utils.profiling, each part's seconds logged. Returns ({kernel:
    {path: launches}} for K-A, K-C dsigma, K-C drho and K-F (both forms),
    results)."""
    import torch

    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large \
        import resnet50

    seconds, paths, res = {}, {}, {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    model = timed("build", lambda: resnet50(
        num_classes=1000, generator=torch.Generator().manual_seed(SEED + 750),
        device="cuda"))
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.bfloat16
    model.fc.impl = "pallas"
    inner = sorted({layer.mu_kernel.numel() for stage in (
        model.layer1, model.layer2, model.layer3, model.layer4)
        for layer in stage.modules() if hasattr(layer, "mu_kernel")})
    timed("K-A, K-C sweep", layer_sweep, inner,
          "the blocks' draw buffers, which the remat steps draw again")
    model.train()
    x, y = images(SEED + 760), labels(SEED + 760)
    for emission in ("vmap", "scan"):
        res[f"remat {emission} peak GiB"] = timed(
            f"remat gates {emission}", remat_gates, model, emission, x, y)
        ms, launches = timed(f"remat steps {emission}", remat_timed, model,
                             emission)
        res[f"remat {emission} ms"] = ms
        for mode, got in launches.items():
            paths[f"remat_blocks={mode!r} {emission} MC-{TRAIN_MC} bs{BATCH}"
                  f", 3 steps"] = got
    timed("profile", remat_profile, model)
    set_bn_statistics(model, images(SEED + 770))
    model.fc.impl = "xla"
    res["structured ms"] = timed("structured", structured_check, model)
    del model
    torch.cuda.empty_cache()

    qmodel, _ = timed("int8 build", phase_int8_build, images(SEED + 780))
    res["int8 reparameterization"] = timed(
        "int8 reparameterization", int8_draw_axis, "int8 draw axis", qmodel,
        {"K-F": INT8_LAYERS, "K-F flipout": 0})
    del qmodel
    torch.cuda.empty_cache()
    qmodel = timed("int8 flipout build", phase_int8_flipout_build)
    res["int8 flipout"] = timed("int8 flipout", int8_draw_axis,
                                "int8 flipout draw axis", qmodel,
                                {"K-F": INT8_LAYERS,
                                 "K-F flipout": INT8_LAYERS})
    del qmodel
    torch.cuda.empty_cache()
    for name, r in (("int8 reparameterization", res["int8 "
                                                    "reparameterization"]),
                    ("int8 flipout", res["int8 flipout"])):
        for emission, v in r.items():
            paths[f"{name} MC-{NUM_MC} bs{BATCH} {emission}, 1 batch"] = \
                v["launches"]
    res["quantized lstm"] = timed("quantized lstm",
                                  quantized_lstm_interleaved)
    paths["modes trainer --remat --structured-mc"] = timed(
        "trainer", modes_trainer)
    torch.cuda.empty_cache()
    log(f"[modes] seconds per part: {seconds}")
    by_kernel = {k: {path: got.get(k, 0) for path, got in paths.items()
                     if got.get(k, 0)}
                 for k in ("K-A", "K-C dsigma", "K-C drho", "K-F",
                           "K-F flipout")}
    for k, v in by_kernel.items():
        check(v, f"{k} never ran on phase 42's paths")
    return by_kernel, res


MULTIRANK_SEED = SEED + 800
MULTIRANK_WORLD = 2  # two ranks sharing the one card
MULTIRANK_TIMEOUT = 600  # the ranks' wall-clock limit, seconds
TP_BATCH, TP_MC = 8, 2  # TP gathers every layer's output: a cut batch
HEAD_K, HEAD_N = 2048, 1000  # the ResNet-50 head: x (M, 2048) @ W^T (1000)
PALLAS_STEP = f"pallas head mc=2 vmap MC-{TRAIN_MC} bs{BATCH} f32 SGD step"
# the fused-GEMM head's launches a rank: one K-B with lanes a forward; a
# step's backward one K-D and one K-E with lanes
PALLAS_MESH_LAUNCHES = {
    f"pallas head mc=2 vmap MC-{NUM_MC} bs{BATCH}": {"K-B lanes": 1},
    f"pallas head data=2 vmap MC-{NUM_MC} bs{BATCH}": {"K-B lanes": 1},
    PALLAS_STEP: {"K-B lanes": 1, "K-D lanes": 1, "K-E lanes": 1},
}
LOOP_BATCH, LOOP_MC = 32, 2
MULTIRANK_LR = 0.01
LOADER_IMAGES = 1024  # 8 batches of 128 at 224x224


MESH_LSTM_SEED = MULTIRANK_SEED + 30
MESH_LSTM_TRAIN_MC = 4  # the LSTM's vmap SGD step: MC-4 bs128
F32_ULPS = 64  # the LSTM's gate where a rank's shapes differ (data, TP)


def f32_bound(want, ulps=F32_ULPS):
    """``ulps`` f32 ulps of the largest |value| of ``want``: the gate of an
    f32 mesh run against one process where a rank's products have other
    shapes (64 rows, a gathered head) and may sum in another order."""
    import torch

    _, e = torch.frexp(want.float().abs().max())
    return float(ulps * torch.ldexp(torch.ones(()), e - 24))


@contextlib.contextmanager
def grouped_draw_convs(groups=2):
    """Inside: every draw-axis conv (``ops.conv.conv_draws``, not
    transposed) of S draws runs as ``groups`` convs of S / groups draws in
    turn, their outputs concatenated on the channels: in one process, the
    conv shapes a rank of an ``mc=groups`` mesh gives cuDNN, and nothing
    else changed (ROADMAP F10). The package has no such switch."""
    import torch

    from bayesian_torch_tpu_torch.ops import conv as conv_ops

    real = conv_ops.conv_draws

    def split(x, w, b=None, **kw):
        S = w.shape[0]
        if kw.get("transposed") or S % groups or S == groups:
            return real(x, w, b, **kw)
        per = S // groups
        cin, _ = conv_ops._channels(w[0], kw.get("groups", 1), False)
        shared = conv_ops._shared_input(x, S, cin)
        outs = []
        for k in range(groups):
            xk = x if shared else x.narrow(1, k * per * cin, per * cin)
            outs.append(real(xk, w[k * per:(k + 1) * per],
                             None if b is None else b[k * per:(k + 1) * per],
                             **kw))
        return torch.cat(outs, dim=1)

    conv_ops.conv_draws = split
    try:
        yield
    finally:
        conv_ops.conv_draws = real


def lstm_mesh_step(model, x, y, mesh=None, emission="vmap",
                   num_mc=MESH_LSTM_TRAIN_MC):
    """One MC ELBO step of the LSTM regressor with SGD (MC-4 through the
    vmap emission unless asked): the trainer's Gaussian NLL of the draws'
    predictions + KL / batch; under a mesh on this rank's rows, the
    gradients summed (``reduce_gradients``), as ``make_train_step(mesh=)``
    does. Returns the loss."""
    import torch

    from bayesian_torch_tpu_torch.examples.main_bayesian_lstm_timeseries \
        import gaussian_nll
    from bayesian_torch_tpu_torch.parallel import (mc_forward,
                                                   reduce_gradients,
                                                   shard_batch)

    opt = torch.optim.SGD(model.parameters(), lr=MULTIRANK_LR)
    opt.zero_grad(set_to_none=True)
    xs = x if mesh is None else shard_batch(x, mesh)
    outs, kl = mc_forward(model, xs, num_mc, mesh=mesh, emission=emission)
    loss = gaussian_nll(outs, y) + kl / LSTM_BATCH
    loss.backward()
    if mesh is not None:
        reduce_gradients(model, mesh)
    opt.step()
    return float(loss.detach())


def lstm_quantized_model():
    """Phase 43's quantized LSTM regressor: ``bnn_to_qbnn`` of the
    reparameterization one."""
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn

    model = lstm_model("Reparameterization", MESH_LSTM_SEED).eval()
    bnn_to_qbnn(model)
    return model


def lstm_mesh_references():
    """(f) The one-process side of phase 43's LSTM parts, config #4 (MC-20
    bs128, seq 64, hidden 64, f32), from one state and generator state per
    model: each estimator's MC-20 outputs through the loop and the vmap
    emission and the parameters after an MC-4 vmap SGD step (and its
    largest update); the quantized LSTM's MC-20 loop outputs. Returns
    them on the CPU with the batch, the states and the generator
    states."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    x, y = lstm_windows(MESH_LSTM_SEED + 1)
    refs = {"x": x.cpu(), "y": y.cpu()}
    for est in ESTIMATORS:
        model = lstm_model(est, MESH_LSTM_SEED).eval()
        gens = gen_states(model)
        state = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
        r = {"state": state, "gens": gens}
        with torch.no_grad():
            for emission in ("scan", "vmap"):
                set_gens(model, gens)
                r[emission] = mc_forward(model, x, LSTM_MC, emission=emission,
                                         return_kl=False).cpu()
        model.train()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        for emission, num_mc in (("vmap", MESH_LSTM_TRAIN_MC),
                                 ("scan", LOOP_MC)):
            model.load_state_dict(state)
            set_gens(model, gens)
            loss = lstm_mesh_step(model, x, y, emission=emission,
                                  num_mc=num_mc)
            r[f"{emission} step"] = {
                "loss": loss, "update": max(
                    max_err(p, before[n])
                    for n, p in model.named_parameters()),
                "after": {n: p.detach().cpu().clone()
                          for n, p in model.named_parameters()}}
        refs[est] = r
    qmodel = lstm_quantized_model()
    gens = gen_states(qmodel)
    with torch.no_grad():
        out = mc_forward(qmodel, x, LSTM_MC, emission="scan",
                         return_kl=False)
    refs["quantized"] = {"state": {k: v.detach().cpu().clone() for k, v
                                   in qmodel.state_dict().items()},
                         "gens": gens, "scan": out.cpu()}
    return refs


def lstm_window_checks():
    """(f) The windows a rank's LSTM draws on the card: at the LSTM's
    draw buffers (ih W 256 x 1, hh W 256 x 64, a bias 256), K-A over rank
    1's 10 of 20 draws (lanes [640, 1280) of the MC-20 launch over 20 x 64
    lanes) and over a 'model' shard's rows [128, 256) of those lanes
    equal the whole launch's lanes and rows bit for bit and their plain
    versions within 1e-5; K-C dsigma on the same windows within 1e-5 x
    max(1, max|plain|) of its plain version and of the whole launch with
    the cotangent on those lanes. Comparison launches: counted on no
    path. Returns the largest errors."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    h4, lanes = 4 * LSTM_HIDDEN, LSTM_MC * LSTM_SEQ
    half = lanes // 2
    shapes = {"ih W": (h4, 1), "hh W": (h4, LSTM_HIDDEN), "bias": (h4,)}
    worst = dict(sample=0.0, dsigma=0.0)
    for i, (name, shape) in enumerate(shapes.items()):
        gen = torch.Generator().manual_seed(MESH_LSTM_SEED + 10 + i)
        mu = (0.3 * torch.randn(shape, generator=gen)).cuda()
        sigma = sigma_from_rho(torch.randn(shape, generator=gen)
                               - 3.0).cuda()
        n = mu.numel()
        k = n // h4  # a row's elements
        seed = 0x5EED_0000_0000_4300 + i
        whole = ka.sample_scaled_normals_batch(seed, mu, sigma, lanes,
                                               torch.float32)
        window = (half, n, 0)
        part = ka.sample_scaled_normals_batch(seed, mu, sigma, half,
                                              torch.float32, window=window)
        rows = ka.sample_scaled_normals_batch(
            seed, mu[h4 // 2:], sigma[h4 // 2:], half, torch.float32,
            window=(half, n, (h4 // 2) * k))
        check(torch.equal(part, whole[half:])
              and torch.equal(rows, whole[half:, h4 // 2:]),
              f"K-A's window at the LSTM's {name} is not the whole launch's "
              "lanes and rows")
        e_a = max(max_err(part, ka.sample_scaled_normals_batch_plain(
            seed, mu, sigma, half, torch.float32, window=window)),
            max_err(rows, ka.sample_scaled_normals_batch_plain(
                seed, mu[h4 // 2:], sigma[h4 // 2:], half, torch.float32,
                window=(half, n, (h4 // 2) * k))))
        g = torch.randn((half,) + shape, generator=gen).cuda()
        placed = torch.zeros((lanes,) + shape, device="cuda")
        placed[half:] = g
        got = ka.dsigma(seed, g, window=window)
        plain = ka.dsigma_plain(seed, g, window=window)
        scale = max(1.0, plain.abs().max().item())
        e_c = max(max_err(got, plain), max_err(got, ka.dsigma(seed, placed))
                  ) / scale
        log(f"[multirank lstm windows] {name} {tuple(shape)}: K-A over "
            f"lanes [{half}, {lanes}) and rows [{h4 // 2}, {h4}) equal to "
            f"the whole launch's bit for bit, {e_a:.3e} from plain (limit "
            f"1e-5); K-C dsigma {e_c:.3e} x max(1, max|plain|) from plain "
            "and from the whole launch (limit 1e-5)")
        check(e_a <= 1e-5 and e_c <= 1e-5,
              f"K-A or K-C windowed off at the LSTM's {name}")
        worst["sample"] = max(worst["sample"], e_a)
        worst["dsigma"] = max(worst["dsigma"], e_c)
    return worst


# (g) the windows a rank's fused-GEMM head draws: (label, lanes of the
# one-process launch, first lane, first row) at the ResNet-50 head; the
# window's lanes are the rest of the launch's, its rows the rest of N
HEAD_WINDOWS = [
    (f"mc=2 MC-{NUM_MC}, rank 1's lanes", NUM_MC, NUM_MC // 2, 0),
    (f"mc=2 MC-{TRAIN_MC} step, rank 1's lanes", TRAIN_MC, TRAIN_MC // 2, 0),
    ("model=2, shard 1's rows, one draw", 1, 0, HEAD_N // 2),
    (f"model=2, shard 1's rows, MC-{TP_MC}", TP_MC, 0, HEAD_N // 2),
]


def head_window_checks():
    """(g) K-B, K-D and K-E under the counter windows a rank's head draws
    on the mesh paths (``HEAD_WINDOWS``), at the ResNet-50 head (M = 128,
    K = 2048), f32 with TF32 off: each against its windowed plain version
    within 1e-4 x max(1, max|plain|); a rank's lanes of K-B and K-D equal
    those lanes of the whole launch bit for bit. One draw runs the
    single-draw entry points (K-E's kernel without lane sums).
    Comparison launches: counted on no path. Returns the largest errors
    over max(1, max|plain|)."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    M, K, N = BATCH, HEAD_K, HEAD_N
    gen = torch.Generator().manual_seed(MULTIRANK_SEED + 30)
    mu_all = (0.1 * torch.randn((N, K), generator=gen)).cuda()
    rho_all = (0.1 * torch.randn((N, K), generator=gen) - 3.0).cuda()
    worst = {"K-B": 0.0, "K-D": 0.0, "K-E": 0.0}
    with tf32_off():
        for i, (label, lanes, lane0, n0) in enumerate(HEAD_WINDOWS):
            seed = 0x5EED_0000_0000_4320 + i
            S, window = lanes - lane0, (lane0, N * K, n0 * K)
            mu, rho = mu_all[n0:], rho_all[n0:]
            sigma = sigma_from_rho(rho)
            x_all = torch.randn((lanes, M, K), generator=gen).cuda()
            x = x_all[lane0:]
            g = torch.randn((S, M, N - n0), generator=gen).cuda()
            if lanes == 1:
                got = {"K-B": kb.sampled_matmul(
                           seed, x[0], mu, rho, window=window)[None],
                       "K-D": kb.sampled_matmul_dx(
                           seed, g[0], mu, sigma, window=window)[None],
                       "K-E": kb.sampled_matmul_dw(seed, g[0], x[0],
                                                   window=window)}
            else:
                got = {"K-B": kb.sampled_matmul_batched(
                           seed, x, mu, rho, S, window=window),
                       "K-D": kb.sampled_matmul_dx_batched(
                           seed, g, mu, sigma, window=window),
                       "K-E": kb.sampled_matmul_dw_batched(
                           seed, g, x, window=window)}
            want = {"K-B": kb.sampled_matmul_batched_plain(
                        seed, x, mu, sigma, S, window=window),
                    "K-D": kb.sampled_matmul_dx_batched_plain(
                        seed, g, mu, sigma, window),
                    "K-E": kb.sampled_matmul_dw_batched_plain(
                        seed, g, x, window)}
            errs = {}
            for k in worst:
                pairs = zip(got[k], want[k]) if k == "K-E" \
                    else [(got[k], want[k])]
                errs[k] = max(max_err(a, b) / max(1.0, b.abs().max().item())
                              for a, b in pairs)
                worst[k] = max(worst[k], errs[k])
            exact = "n/a"
            if n0 == 0:
                whole = kb.sampled_matmul_batched(seed, x_all, mu, rho, lanes)
                g_all = torch.cat([g.new_zeros((lane0,) + g.shape[1:]), g])
                exact = torch.equal(got["K-B"], whole[lane0:]) and \
                    torch.equal(got["K-D"], kb.sampled_matmul_dx_batched(
                        seed, g_all, mu, sigma)[lane0:])
                check(exact, f"(g) {label}: K-B or K-D's lanes differ from "
                      "the whole launch's")
            log(f"[multirank head windows] {label}: lanes [{lane0}, {lanes}) "
                f"of {lanes}, rows [{n0}, {N}) of {N}, window {window}: "
                f"x max(1, max|plain|) from plain "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (limit 1e-4); lanes equal to the whole launch's: {exact}")
            check(max(errs.values()) <= 1e-4,
                  f"(g) {label}: a windowed kernel is off its plain version "
                  f"{errs}")
    return worst


def lstm_parts(ref, part, meshes):
    """(f) Phase 43's LSTM parts on one rank (every rank runs them in the
    same order): each estimator's regressor at ``mc=2`` through the loop
    and the vmap emission and at ``data=2`` through vmap, an MC-4 vmap SGD
    step at ``mc=2``, ``shard_params_tp`` over ``model=2``; the quantized
    LSTM at ``mc=2`` through the loop; each against the one-process
    reference."""
    import torch

    from bayesian_torch_tpu_torch.parallel import (mc_forward, shard_batch,
                                                   shard_params_tp)

    x, y = ref["x"].cuda(), ref["y"].cuda()
    mc2, data2, tp2 = meshes

    def forward(model, gens, mesh, want, emission, tp=False):
        set_gens(model, gens)
        with torch.no_grad():
            if tp:
                got = mc_forward(model, x, LSTM_MC, return_kl=False,
                                 emission=emission)
            else:
                got = mc_forward(model, shard_batch(x, mesh), LSTM_MC,
                                 mesh=mesh, return_kl=False,
                                 emission=emission)
        return {"err": max_err(got, want.cuda()), "bound": f32_bound(want),
                "finite": bool(torch.isfinite(got).all()),
                "shape": tuple(got.shape)}

    for est in ESTIMATORS:
        r = ref[est]
        model = lstm_model(est, MESH_LSTM_SEED).eval()
        model.load_state_dict(r["state"])
        for emission in ("scan", "vmap"):
            part(f"lstm {est} mc=2 {emission}", lambda: forward(
                model, r["gens"], mc2, r[emission], emission))
        part(f"lstm {est} data=2 vmap", lambda: forward(
            model, r["gens"], data2, r["vmap"], "vmap"))

        def step(emission, num_mc):
            model.load_state_dict(r["state"])
            model.train()
            set_gens(model, r["gens"])
            loss = lstm_mesh_step(model, x, y, mc2, emission, num_mc)
            want = r[f"{emission} step"]
            err = max(max_err(p, want["after"][n].cuda())
                      for n, p in model.named_parameters())
            model.eval()
            return {"loss": loss, "loss_one_process": want["loss"],
                    "param_err": err, "update": want["update"]}

        part(f"lstm {est} mc=2 vmap MC-{MESH_LSTM_TRAIN_MC} step",
             lambda: step("vmap", MESH_LSTM_TRAIN_MC))
        part(f"lstm {est} mc=2 scan MC-{LOOP_MC} step",
             lambda: step("scan", LOOP_MC))

        def tensor_parallel():
            tp_model = lstm_model(est, MESH_LSTM_SEED).eval()
            tp_model.load_state_dict(r["state"])
            count = shard_params_tp(tp_model, tp2)
            return dict(forward(tp_model, r["gens"], None, r["vmap"],
                                "vmap", tp=True), sharded=count)

        part(f"lstm {est} model=2 TP", tensor_parallel)
        del model
    q = ref["quantized"]
    qmodel = lstm_quantized_model()
    qmodel.load_state_dict(q["state"])
    part("lstm quantized mc=2 scan", lambda: forward(
        qmodel, q["gens"], mc2, q["scan"], "scan"))


# the LSTM parts' launches a rank: the loop runs every draw on every rank
# (the head's presample and 4 a draw, as one process); vmap draws the
# rank's lanes (its 10 of 20 draws: 10 x 64 lanes a tensor, 5 launches);
# data=2 all 20 draws on 64 rows; the step K-A and K-C dsigma 5 each; TP
# the gathered LSTM's 4 whole launches and the column head's 2 windows
LSTM_MESH_LAUNCHES = {
    "mc=2 scan": {"K-A": 1 + LSTM_TENSORS * LSTM_MC},
    "mc=2 vmap": {"K-A": 1 + LSTM_TENSORS},
    "data=2 vmap": {"K-A": 1 + LSTM_TENSORS},
    f"mc=2 vmap MC-{MESH_LSTM_TRAIN_MC} step": {
        "K-A": 1 + LSTM_TENSORS, "K-C dsigma": 1 + LSTM_TENSORS},
    # every draw on every rank (the LSTM's lanes and the head's two single
    # draws each), the backward of the rank's own draw alone
    f"mc=2 scan MC-{LOOP_MC} step": {
        "K-A": LOOP_MC * (2 + LSTM_TENSORS), "K-C dsigma": LSTM_TENSORS,
        "K-C drho": 2},
    "model=2 TP": {"K-A": 2 + LSTM_TENSORS},
}


def bf16_bound(want, ulps=8):
    """``ulps`` bf16 ulps of the largest |value| of ``want``: the gate of
    a mesh run against one process where the per-rank shapes differ (a
    smaller batch or fewer lanes may take another cuDNN algorithm)."""
    return float(ulps * bf16_ulp(want.float().abs().max()))


def multirank_model():
    """ResNet-50 as phase 43 builds it in every process, bf16 compute."""
    import torch

    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large \
        import resnet50

    model = resnet50(num_classes=1000,
                     generator=torch.Generator().manual_seed(MULTIRANK_SEED),
                     device="cuda")
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.bfloat16
    return model


@contextlib.contextmanager
def f32_compute(model):
    """The model's layers in f32 with TF32 off inside: the arithmetic in
    which a mesh step and the one-process step differ by summation order
    alone."""
    saved = {m: m.compute_dtype for m in model.modules()
             if hasattr(m, "compute_dtype")}
    for m in saved:
        m.compute_dtype = None
    try:
        with tf32_off():
            yield
    finally:
        for m, dtype in saved.items():
            m.compute_dtype = dtype


def gen_states(model):
    from bayesian_torch_tpu_torch.ops.sampling import module_generators

    return [g.get_state() for g in module_generators(model)]


def set_gens(model, states):
    from bayesian_torch_tpu_torch.ops.sampling import module_generators

    for g, state in zip(module_generators(model), states):
        g.set_state(state)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multirank_one_process(model, x, gens0, want):
    """(a) An NCCL world of one in this process: one all-reduce, then
    ``mc_forward(mesh=make_mesh(mc=1))`` (the vmap emission, as "auto"
    resolves under a mesh) against the same forward without a mesh.
    Returns (max |difference|, launches)."""
    import torch
    import torch.distributed as dist

    from bayesian_torch_tpu_torch.parallel import (initialize, make_mesh,
                                                   mc_forward)

    n = initialize(f"127.0.0.1:{free_port()}", num_processes=1,
                   process_id=0, initialization_timeout=120)
    try:
        check(n == 1 and dist.get_backend() == "nccl",
              f"initialize: world {n}, backend {dist.get_backend()}")
        t = torch.full((1,), 3.0, device="cuda")
        dist.all_reduce(t)
        check(float(t) == 3.0, "NCCL all-reduce over a world of one")
        mesh = make_mesh(mc=1)
        set_gens(model, gens0)
        reset_counts()
        with torch.no_grad():
            got = mc_forward(model, x, NUM_MC, mesh=mesh, return_kl=False)
        torch.cuda.synchronize()
        launches = nonzero(counts())
    finally:
        dist.destroy_process_group()
    err = max_err(got, want)
    check(err == 0.0, f"(a) mc_forward(mesh=make_mesh(mc=1)) differs from "
          f"no mesh by {err:.3e}")
    return err, launches


def multirank_parts(tmp, rank):
    """Phase 43's parts (b) to (d) on one rank of two sharing the card;
    every rank runs every part in the same order (each builds process
    groups and calls collectives). Returns {part: result} with each
    part's seconds, launches and error against the one-process run."""
    import contextlib as ctx
    import hashlib
    import io
    import os

    import torch
    import torch.distributed as dist

    from bayesian_torch_tpu_torch.examples._engine import make_train_step
    from bayesian_torch_tpu_torch.graft_entry import _dryrun_body
    from bayesian_torch_tpu_torch.parallel import (make_mesh, mc_forward,
                                                   replicate, shard_batch,
                                                   shard_params_tp)

    ref = torch.load(os.path.join(tmp, "ref.pt"), weights_only=False)
    x, y = ref["x"].cuda(), ref["y"].cuda()
    gens0 = ref["gens0"]
    model = multirank_model()
    model.load_state_dict(ref["state"])
    model.eval()
    out = {}

    def part(name, fn):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        res = dict(res, seconds=round(time.perf_counter() - t0, 1),
                   launches=nonzero(counts()))
        out[name] = res
        log(f"[multirank] rank {rank} {name}: "
            + json.dumps(res, default=str)[:600])

    mc2 = make_mesh(mc=2)
    data2 = make_mesh(mc=1, data=2)
    tp2 = make_mesh(mc=1, data=1, model=2)

    def forward(mesh, want, **kw):
        set_gens(model, gens0)
        with torch.no_grad():
            got = mc_forward(model, shard_batch(x, mesh), NUM_MC, mesh=mesh,
                             return_kl=False, **kw)
        return {"err": max_err(got, want.cuda()),
                "bound": bf16_bound(want),
                "finite": bool(torch.isfinite(got).all()),
                "shape": tuple(got.shape)}

    part("mc=2 scan", lambda: forward(mc2, ref["scan"], emission="scan"))
    part("data=2 scan", lambda: forward(data2, ref["scan"],
                                        emission="scan"))
    with pointwise_dot():
        part("mc=2 vmap CONV_1X1_DOT", lambda: forward(
            mc2, ref["dot"], emission="vmap"))

    def vmap_step(dtype):
        model.load_state_dict(ref["state"])
        model.train()
        set_gens(model, gens0)
        opt = torch.optim.SGD(model.parameters(), lr=MULTIRANK_LR)
        with (f32_compute(model) if dtype.startswith("f32")
              else contextlib.nullcontext()):
            loss, _, _ = make_train_step(TRAIN_MC, BATCH, mc2,
                                         emission="vmap")(
                model, opt, shard_batch(x, mc2), y)
        want = ref["steps"][dtype]
        errs = sorted(((max_err(p, want["after"][n].cuda()), n)
                       for n, p in model.named_parameters()), reverse=True)
        res = {"loss": float(loss), "loss_one_process": want["loss"],
               "param_err": errs[0][0], "update": want["update"],
               "limit": want["update"] / 256, "worst": errs[:3]}
        if dtype == "bf16":
            # against the one-process step whose draw-axis convs ran in
            # two groups of S = 2, as this rank's do (F10)
            grouped = ref["steps"]["bf16 grouped"]
            res["param_err_grouped"] = max(
                max_err(p, grouped["after"][n].cuda())
                for n, p in model.named_parameters())
            res["loss_grouped"] = grouped["loss"]
        return res

    for dtype in ("bf16", "f32"):
        part(f"mc=2 vmap MC-{TRAIN_MC} bs{BATCH} {dtype} SGD step",
             lambda: vmap_step(dtype))

    def loop_step():
        set_gens(model, gens0)
        opt = torch.optim.SGD(model.parameters(), lr=MULTIRANK_LR)
        xs = x[:LOOP_BATCH]
        loss, _, _ = make_train_step(LOOP_MC, LOOP_BATCH, mc2,
                                     emission="scan")(
            model, opt, shard_batch(xs, mc2), y[:LOOP_BATCH])
        return {"loss": float(loss), "finite": bool(all(
            torch.isfinite(p).all() for p in model.parameters()))}

    part(f"mc=2 scan MC-{LOOP_MC} bs{LOOP_BATCH} SGD step", loop_step)

    # the head on the fused sampled GEMM: a rank's lanes of K-B (and K-D,
    # K-E in the step) under mc=2, all lanes on its rows under data=2
    model.load_state_dict(ref["state"])
    model.eval()
    model.fc.impl = "pallas"
    part(f"pallas head mc=2 vmap MC-{NUM_MC} bs{BATCH}", lambda: forward(
        mc2, ref["pallas vmap"], emission="vmap"))
    part(f"pallas head data=2 vmap MC-{NUM_MC} bs{BATCH}", lambda: forward(
        data2, ref["pallas vmap"], emission="vmap"))
    part(PALLAS_STEP, lambda: vmap_step("f32 pallas"))
    del model
    torch.cuda.empty_cache()

    def tensor_parallel():
        tp_model = multirank_model()
        tp_model.load_state_dict(ref["state"])
        replicate(tp_model, tp2)
        count = shard_params_tp(tp_model, tp2)
        tp_model.eval()
        set_gens(tp_model, gens0)
        with torch.no_grad():
            got = mc_forward(tp_model, x[:TP_BATCH], TP_MC, return_kl=False,
                             emission="vmap")
        return {"sharded": count, "err": max_err(got, ref["tp"].cuda()),
                "bound": bf16_bound(ref["tp"])}

    part(f"model=2 TP MC-{TP_MC} bs{TP_BATCH}", tensor_parallel)
    torch.cuda.empty_cache()
    lstm_parts(ref["lstm"], part, (mc2, data2, tp2))
    torch.cuda.empty_cache()
    part("dryrun_multichip(2)", lambda: _dryrun_body(MULTIRANK_WORLD,
                                                     "cuda"))
    torch.cuda.empty_cache()

    def trainer():
        from bayesian_torch_tpu_torch.examples import main_bayesian_imagenet

        built = []
        real = main_bayesian_imagenet.get_model
        main_bayesian_imagenet.get_model = \
            lambda *a, **k: built.append(real(*a, **k)) or built[-1]
        argv = ["--synthetic", f"--batch-size={TRAINER_BATCH}",
                "--num_mc=2", "--mesh-mc=2",
                f"--save_dir={os.path.join(tmp, 'trainer')}"]
        text = io.StringIO()
        try:
            with ctx.redirect_stdout(text):
                main_bayesian_imagenet.main(argv + ["--epochs=2"])
                dist.barrier()
                metrics = main_bayesian_imagenet.main(
                    argv + ["--epochs=3", "--resume"])
        finally:
            main_bayesian_imagenet.get_model = real
        digest = hashlib.sha256()
        for t in built[-1].state_dict().values():
            digest.update(t.detach().cpu().contiguous().numpy().tobytes())
        lines = text.getvalue().strip().splitlines()
        # only the mesh's first rank prints
        return {"digest": digest.hexdigest(), "metrics": metrics,
                "resumed": any("resumed from epoch 2" in ln
                               for ln in lines), "last_lines": lines[-2:]}

    part("imagenet trainer --mesh-mc=2", trainer)
    return out


def multirank_rank(tmp, rank, world, port, parts="multirank_parts"):
    """A spawned rank of phase 43 (or 45): join the world (gloo: two ranks
    on one card), run the function ``parts`` of this script (phase 43's,
    or ``nhwc_mesh_parts``), pickle the result or the error."""
    import os
    import pickle
    import traceback

    import torch.distributed as dist

    from bayesian_torch_tpu_torch.parallel import initialize

    try:
        initialize(f"127.0.0.1:{port}", num_processes=world,
                   process_id=rank, initialization_timeout=300)
        result = ("ok", dict(globals()[parts](tmp, rank),
                             backend=dist.get_backend()))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = ("err", traceback.format_exc())
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn_multirank(tmp, parts="multirank_parts"):
    """Run ``multirank_rank`` (with ``parts``) in MULTIRANK_WORLD
    processes of this script's directory; kill them after
    MULTIRANK_TIMEOUT seconds. Returns each rank's result; raises with a
    failing rank's traceback and the tail of its output."""
    import os
    import pickle

    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs, logs = [], []
    for r in range(MULTIRANK_WORLD):
        logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as c; "
             f"c.multirank_rank({tmp!r}, {r}, {MULTIRANK_WORLD}, {port}, "
             f"{parts!r})"],
            cwd=root, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + MULTIRANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"chip_smoke: {parts}'s ranks did not finish "
                           f"within {MULTIRANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results = []
    for r in range(MULTIRANK_WORLD):
        path = os.path.join(tmp, f"rank{r}.pkl")
        with open(os.path.join(tmp, f"rank{r}.log")) as f:
            tail = f.read()[-6000:]
        check(os.path.exists(path), f"rank {r} wrote no result:\n{tail}")
        with open(path, "rb") as f:
            kind, value = pickle.load(f)
        check(kind == "ok", f"rank {r} failed:\n{value}\n{tail}")
        results.append(value)
    return results


def loader_rates():
    """(e) One epoch of LOADER_IMAGES 224x224 images at batch 128 to the
    card through the native ``DataLoader`` and through its numpy path:
    batches per second each, the native order checked to be a
    permutation."""
    import numpy as np
    import torch

    from bayesian_torch_tpu_torch.data import DataLoader, native_available

    check(native_available(), "the native DataLoader did not build")
    rng = np.random.default_rng(SEED + 820)
    x = rng.standard_normal((LOADER_IMAGES, 3, IMAGE, IMAGE),
                            dtype=np.float32)
    x[:, 0, 0, 0] = np.arange(LOADER_IMAGES)
    y = rng.integers(0, 1000, LOADER_IMAGES, dtype=np.int32)
    loader = DataLoader(x, y, batch_size=BATCH, num_workers=4)
    rates, seen = {}, []
    for name, epoch in (("native", loader.epoch),
                        ("numpy", loader._numpy_epoch)):
        for warm in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 0
            for xb, yb in epoch(1):
                xd = torch.from_numpy(xb).to("cuda")
                torch.from_numpy(yb).to("cuda")
                if name == "native" and not warm:
                    seen.append(xd[:, 0, 0, 0].long().cpu())
                n += 1
            torch.cuda.synchronize()
            if not warm:
                rates[name] = n / (time.perf_counter() - t0)
    order = torch.cat(seen).tolist()
    check(sorted(order) == list(range(LOADER_IMAGES)),
          "the native loader's epoch is not a permutation")
    return rates


def phase_multirank():
    """Phase 43: the mesh paths (see the module docstring). Returns
    ({kernel: {path: launches}}, results)."""
    import os
    import tempfile

    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step
    from bayesian_torch_tpu_torch.parallel import mc_forward

    seconds, res = {}, {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    model = timed("build", multirank_model)
    set_bn_statistics(model, images(MULTIRANK_SEED + 1))
    x, y = images(MULTIRANK_SEED + 2), labels(MULTIRANK_SEED + 2)
    gens0 = gen_states(model)
    refs = {}

    def one_process():
        with torch.no_grad():
            for name, kw, ctx in (
                    ("scan", dict(emission="scan"), contextlib.nullcontext),
                    ("vmap", dict(emission="vmap"), contextlib.nullcontext),
                    ("dot", dict(emission="vmap"), pointwise_dot)):
                set_gens(model, gens0)
                with ctx():
                    refs[name] = mc_forward(model, x, NUM_MC,
                                            return_kl=False, **kw)
            set_gens(model, gens0)
            refs["tp"] = mc_forward(model, x[:TP_BATCH], TP_MC,
                                    return_kl=False, emission="vmap")
            model.fc.impl = "pallas"
            set_gens(model, gens0)
            refs["pallas vmap"] = mc_forward(model, x, NUM_MC,
                                             return_kl=False,
                                             emission="vmap")
            model.fc.impl = "xla"

    timed("one-process references", one_process)
    res["(a) one-rank NCCL world"] = timed(
        "(a) NCCL world of one", multirank_one_process, model, x, gens0,
        refs["vmap"])
    log(f"[multirank] (a) an NCCL world of one: mc_forward(mesh=make_mesh("
        f"mc=1)) against no mesh, max |diff| and launches: "
        f"{res['(a) one-rank NCCL world']}")
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    def step(dtype, grouped=False, impl="xla"):
        model.load_state_dict(state)
        model.train()
        set_gens(model, gens0)
        model.fc.impl = impl
        opt = torch.optim.SGD(model.parameters(), lr=MULTIRANK_LR)
        with (f32_compute(model) if dtype == "f32"
              else contextlib.nullcontext()), \
                (grouped_draw_convs(MULTIRANK_WORLD) if grouped
                 else contextlib.nullcontext()):
            loss, _, _ = make_train_step(TRAIN_MC, BATCH, emission="vmap")(
                model, opt, x, y)
        model.fc.impl = "xla"
        return {"loss": float(loss),
                "after": {n: p.detach().cpu().clone()
                          for n, p in model.named_parameters()},
                "update": max(max_err(p, before[n])
                              for n, p in model.named_parameters())}

    steps = {dtype: timed(f"one-process {dtype} step", step, dtype)
             for dtype in ("bf16", "f32")}
    steps["f32 pallas"] = timed("one-process f32 step, fused-GEMM head",
                                lambda: step("f32", impl="pallas"))
    again = timed("one-process bf16 step again", step, "bf16")
    spread = max(max_err(again["after"][n], p)
                 for n, p in steps["bf16"]["after"].items())
    log(f"[multirank] the one-process vmap MC-{TRAIN_MC} bs{BATCH} bf16 SGD "
        f"step twice from one state: parameters differ by {spread:.3e}, "
        f"loss {steps['bf16']['loss']} and {again['loss']}")
    # F10: the same bf16 step with every draw-axis conv in two groups of
    # S = 2 (a rank's conv shapes), in this one process
    steps["bf16 grouped"] = timed("one-process bf16 step, grouped convs",
                                  step, "bf16", True)
    grouped_dist = sorted(((max_err(p, steps["bf16"]["after"][n]), n)
                           for n, p in steps["bf16 grouped"]["after"]
                           .items()), reverse=True)
    res["F10 grouped distance"] = grouped_dist[0][0]
    log(f"[multirank] F10: the one-process bf16 vmap MC-{TRAIN_MC} "
        f"bs{BATCH} step with its draw-axis convs in {MULTIRANK_WORLD} "
        f"groups of S = {TRAIN_MC // MULTIRANK_WORLD}: parameters "
        f"{grouped_dist[0][0]:.3e} from the S = {TRAIN_MC} step (update "
        f"{steps['bf16']['update']:.3e}; worst {grouped_dist[:3]}), loss "
        f"{steps['bf16 grouped']['loss']} against "
        f"{steps['bf16']['loss']}; {card()}")
    del model, before, again
    torch.cuda.empty_cache()
    res["(f) LSTM windows"] = timed("(f) LSTM windows", lstm_window_checks)
    res["(g) head windows"] = timed("(g) head windows", head_window_checks)
    lstm_refs = timed("(f) LSTM one-process references",
                      lstm_mesh_references)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"state": state, "gens0": gens0, "x": x.cpu(),
                    "y": y.cpu(), "steps": steps, "lstm": lstm_refs,
                    **{k: v.cpu() for k, v in refs.items()}},
                   os.path.join(tmp, "ref.pt"))
        del state, steps
        ranks = timed("(b)-(d) two ranks", spawn_multirank, tmp)
    for rank, r in enumerate(ranks):
        for name, got in r.items():
            if isinstance(got, dict):
                log(f"[multirank] rank {rank} {name}: " + json.dumps(
                    got, default=str))
    paths = {k: {} for k in ("K-A", "K-C dsigma", "K-C drho", "K-F", "K-G",
                             "K-B lanes", "K-D lanes", "K-E lanes")}
    # gloo for two ranks sharing the one card; NCCL, one card a rank, on
    # a machine with more cards
    backend = "nccl" if torch.cuda.device_count() >= MULTIRANK_WORLD \
        else "gloo"
    for rank, r in enumerate(ranks):
        check(r["backend"] == backend, f"rank {rank}: {r['backend']}, want "
              f"{backend}")
        for name, got in r.items():
            if not isinstance(got, dict):
                continue
            for k in paths:
                if got["launches"].get(k):
                    paths[k][f"mesh {name} (rank {rank})"] = \
                        got["launches"][k]
            if "bound" in got:
                check(got["finite"] if "finite" in got else True,
                      f"rank {rank} {name}: output not finite")
                check(got["err"] <= got["bound"], f"rank {rank} {name}: "
                      f"{got['err']:.3e} from one process, bound "
                      f"{got['bound']:.3e}")
        mc2 = r["mc=2 scan"]
        check(mc2["launches"].get("K-A") == 1, f"rank {rank}: the mc=2 "
              f"loop's K-A launches {mc2['launches']}, want 1 (its lanes)")
        dot = r["mc=2 vmap CONV_1X1_DOT"]
        check(dot["launches"].get("K-G") == N_POINTWISE,
              f"rank {rank}: K-G {dot['launches']}")
        for dtype in ("bf16", "f32"):
            vstep = r[f"mc=2 vmap MC-{TRAIN_MC} bs{BATCH} {dtype} SGD step"]
            check(vstep["launches"].get("K-C dsigma", 0) > 0,
                  f"rank {rank}: no K-C dsigma in the {dtype} vmap step")
        # in f32 without TF32 the ranks' sums differ from one process's by
        # their order alone
        check(vstep["param_err"] <= vstep["update"] / 256,
              f"rank {rank}: f32 parameters {vstep['param_err']:.3e} from "
              f"the one-process step (its update {vstep['update']:.3e}); "
              f"{vstep}")
        for est in ESTIMATORS:
            for name, want in LSTM_MESH_LAUNCHES.items():
                got = r[f"lstm {est} {name}"]["launches"]
                check(all(got.get(k, 0) == v for k, v in want.items()),
                      f"rank {rank}: lstm {est} {name} launches {got}, "
                      f"want {want}")
            for what in (f"vmap MC-{MESH_LSTM_TRAIN_MC}",
                         f"scan MC-{LOOP_MC}"):
                lstep = r[f"lstm {est} mc=2 {what} step"]
                check(lstep["param_err"] <= lstep["update"] / 256,
                      f"rank {rank}: lstm {est} {what} step parameters "
                      f"{lstep['param_err']:.3e} from one process (update "
                      f"{lstep['update']:.3e})")
            check(r[f"lstm {est} model=2 TP"]["sharded"] == 12,
                  f"rank {rank}: lstm {est} TP sharded "
                  f"{r[f'lstm {est} model=2 TP']['sharded']}, want 12")
        qlaunch = r["lstm quantized mc=2 scan"]["launches"]
        check(qlaunch.get("K-F") == LSTM_MC and not qlaunch.get("K-A"),
              f"rank {rank}: the quantized LSTM's launches {qlaunch}, want "
              f"K-F {LSTM_MC} (the head, every draw on every rank)")
        bstep = r[f"mc=2 vmap MC-{TRAIN_MC} bs{BATCH} bf16 SGD step"]
        log(f"[multirank] F10, rank {rank}: the bf16 mesh step's parameters "
            f"{bstep['param_err']:.3e} from the one-process S = {TRAIN_MC} "
            f"step and {bstep['param_err_grouped']:.3e} from its grouped-conv "
            f"twin, which lies {res['F10 grouped distance']:.3e} from it "
            f"(update {bstep['update']:.3e})")
        # F10: a rank's 2-draw grouped convs take other cuDNN algorithms
        # than the 4-draw ones; in one process the same grouping lands
        # where the mesh does. So the bf16 step is held to its grouped
        # twin as the f32 step to one process (the sums' order alone), and
        # to the S = 4 step at the twin's distance from it in this run
        margin = bstep["update"] / 256
        check(bstep["param_err_grouped"] <= margin
              and bstep["param_err"] <= res["F10 grouped distance"] + margin,
              f"rank {rank}: bf16 parameters {bstep['param_err_grouped']:.3e}"
              f" from the grouped-conv twin and {bstep['param_err']:.3e} "
              f"from the S = {TRAIN_MC} step, whose distance from the twin "
              f"is {res['F10 grouped distance']:.3e} (margin {margin:.3e})")
        for name, want in PALLAS_MESH_LAUNCHES.items():
            got = r[name]["launches"]
            check(all(got.get(k, 0) == v for k, v in want.items())
                  and not any(got.get(k) for k in ("K-B", "K-D", "K-E")),
                  f"rank {rank}: {name} launches {got}, want {want}")
        pstep = r[PALLAS_STEP]
        check(pstep["param_err"] <= pstep["limit"],
              f"rank {rank}: {PALLAS_STEP} parameters "
              f"{pstep['param_err']:.3e} from the one-process step, limit "
              f"{pstep['limit']:.3e}; {pstep}")
        log(f"[multirank] rank {rank}, the fused-GEMM head: " + "; ".join(
            f"{name} {r[name]['err']:.3e} from one process (limit "
            f"{r[name]['bound']:.3e})" for name in PALLAS_MESH_LAUNCHES
            if name != PALLAS_STEP)
            + f"; {PALLAS_STEP} parameters {pstep['param_err']:.3e} (limit "
            f"{pstep['limit']:.3e}); launches "
            + json.dumps({name: r[name]["launches"]
                          for name in PALLAS_MESH_LAUNCHES}))
        loop = r[f"mc=2 scan MC-{LOOP_MC} bs{LOOP_BATCH} SGD step"]
        check(loop["finite"] and loop["launches"].get("K-C drho", 0) > 0,
              f"rank {rank}: loop step {loop}")
        check(r["dryrun_multichip(2)"]["launches"].get("K-F", 0) > 0,
              f"rank {rank}: no K-F under the mesh")
        tr = r["imagenet trainer --mesh-mc=2"]
        check(0.0 <= tr["metrics"]["accuracy"] <= 1.0,
              f"rank {rank}: trainer {tr}")
    check(ranks[0]["imagenet trainer --mesh-mc=2"]["resumed"],
          "the trainer's rank 0 did not resume from epoch 2")
    check(ranks[0]["imagenet trainer --mesh-mc=2"]["digest"]
          == ranks[1]["imagenet trainer --mesh-mc=2"]["digest"],
          "the trainer's ranks ended with different weights")
    res["ranks"] = ranks
    res["(e) loader batches/s"] = timed("(e) loader", loader_rates)
    log(f"[multirank] (e) the native loader against the numpy path, "
        f"batches/s of {BATCH} {IMAGE}² images to the card: "
        f"{res['(e) loader batches/s']}; {card()}")
    log(f"[multirank] (f) the LSTM's windowed K-A and K-C at its buffers: "
        f"{res['(f) LSTM windows']}")
    log(f"[multirank] (g) the head's windowed K-B, K-D and K-E, x max(1, "
        f"max|plain|) from plain (limit 1e-4): {res['(g) head windows']}")
    log(f"[multirank] seconds per part: {seconds}")
    for k, v in paths.items():
        check(v, f"{k} never ran on phase 43's paths")
    return paths, res


# --- phase 44: channels-last (data_format="NHWC") ---------------------------

TRANSPOSE_KERNELS = ("nchwToNhwc", "nhwcToNchw", "genericTranspose")


def kgcl_sites():
    """(44a) K-G channels-last against its plain version at the 12
    pointwise sites of ResNet-50 (S = 10, B = 128, bf16, x (M, S, C) with
    M = B*H*W as an NHWC draw-axis activation gives it): forward, dx (the
    kernel on the transposed weight, and one autograd pass: two launches)
    and the S = 1 wrapper at S = 1 (B = 128) and over the B*S batch, each
    beside ``torch.einsum`` on the same operands, with the bound (bytes at
    3.35 TB/s against bf16 at 989 TFLOP/s). Returns the kernels-line
    entries of the forward, the S = 1 wrapper and dx: device-time sums over
    one forward's (backward's) 33 sites."""
    import torch

    from bayesian_torch_tpu_torch.ops import conv as conv_ops
    from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg

    gen = torch.Generator(device="cuda").manual_seed(SEED + 940)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    S = NUM_MC
    sums = {part: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                       bytes=0.0, ops=0.0, err=0.0)
            for part in ("fwd", "one", "dx")}

    def add(part, count, err, ms, plain_ms, lib_ms, nbytes, ops):
        tot = sums[part]
        tot["err"] = max(tot["err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bytes", nbytes),
                       ("ops", ops), ("bound_ms", bound(nbytes, ops,
                                                        BF16_OPS)[0])):
            tot[key] += count * v
        return bound(nbytes, ops, BF16_OPS)

    for ci, co, sp, count in POINTWISE_SITES:
        M = BATCH * sp * sp
        x = rand(BATCH, sp, sp, S * ci)
        w = rand(S, co, ci, 1, 1)
        x3, w3 = x.reshape(M, S, ci), w.reshape(S, co, ci)
        got, want = kg.mc_gemm_cl(x3, w3), kg.mc_gemm_cl_plain(x3, w3)
        err, limit = kg_gate(f"K-G cl at {ci}->{co}@{sp}", got, want)
        via_conv = conv_ops.conv_draws(x, w, pointwise_dot=True,
                                       data_format="NHWC")
        check(torch.equal(via_conv.reshape(got.shape), got),
              "conv_draws(pointwise_dot=True, NHWC) is not K-G cl's output")
        del got, want, via_conv
        ms, plain_ms, lib_ms = device_times(
            (lambda: kg.mc_gemm_cl(x3, w3), "mc_gemm_cl"),
            (lambda: kg.mc_gemm_cl_plain(x3, w3), None),
            (lambda: torch.einsum("msc,soc->mso", x3, w3), None))
        nbytes = 2 * (x.numel() + w.numel() + M * S * co)
        ops = 2 * M * S * co * ci
        b_ms, by = add("fwd", count, err, ms, plain_ms, lib_ms, nbytes, ops)
        log(f"[K-G cl] {ci}->{co}@{sp} x{count}: max|kernel-plain| "
            f"{err:.3e} (limit {limit:.3e}); kernel {ms:.3f} ms "
            f"({nbytes / ms / 1e6:.0f} GB/s, {ops / ms / 1e9:.1f} TFLOP/s), "
            f"torch.einsum {lib_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({by})")
        # the S = 1 wrapper over the M*S rows (one weight), and at S = 1
        for what, rows in (("B*S", x.reshape(M * S, ci)),
                           ("S=1", x3[:, 0].contiguous())):
            w0 = w3[0]
            got = kg.pointwise_gemm_cl(rows, w0)
            err, _ = kg_gate(f"K-G cl S=1 ({what}) at {ci}->{co}@{sp}", got,
                             kg.mc_gemm_cl_plain(rows, w0)[:, 0])
            del got
            ms, plain_ms, lib_ms = device_times(
                (lambda: kg.pointwise_gemm_cl(rows, w0), "mc_gemm_cl"),
                (lambda: kg.mc_gemm_cl_plain(rows, w0), None),
                (lambda: torch.einsum("mc,oc->mo", rows, w0), None))
            nb = 2 * (rows.numel() + w0.numel() + rows.shape[0] * co)
            op = 2 * rows.shape[0] * co * ci
            if what == "B*S":
                b_ms, by = add("one", count, err, ms, plain_ms, lib_ms, nb,
                               op)
            else:
                b_ms, by = bound(nb, op, BF16_OPS)
            log(f"[K-G cl S=1] {what} {ci}->{co}@{sp} x{count}: rows "
                f"{rows.shape[0]}: kernel {ms:.3f} ms, torch.einsum "
                f"{lib_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b_ms:.3f} ms ({by})")
            del rows
        # dx = g . w_s: the kernel on the transposed weight
        g = rand(M, S, co)
        wt = w3.transpose(1, 2).contiguous()
        want = kg.mc_gemm_cl_plain(g, wt)
        err, limit = kg_gate(f"K-G cl dx at {ci}->{co}@{sp}",
                             kg.mc_gemm_cl(g, wt), want)
        xg = x3.clone().requires_grad_(True)
        before = kg.mc_gemm_cl.launches
        kg.mc_gemm_cl(xg, w3).backward(g)
        check(kg.mc_gemm_cl.launches == before + 2, "autograd through "
              f"mc_gemm_cl: {kg.mc_gemm_cl.launches - before} launches, "
              "want 2")
        kg_gate(f"K-G cl autograd dx at {ci}->{co}@{sp}", xg.grad, want)
        del want, xg
        ms, plain_ms, lib_ms = device_times(
            (lambda: kg.mc_gemm_cl(g, wt), "mc_gemm_cl"),
            (lambda: kg.mc_gemm_cl_plain(g, wt), None),
            (lambda: torch.einsum("mso,sco->msc", g, wt), None))
        nbytes = 2 * (g.numel() + wt.numel() + x3.numel())
        b_ms, by = add("dx", count, err, ms, plain_ms, lib_ms, nbytes, ops)
        log(f"[K-G cl dx] {co}->{ci}@{sp} x{count}: max|kernel-plain| "
            f"{err:.3e} (limit {limit:.3e}); kernel {ms:.3f} ms, "
            f"torch.einsum {lib_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({by})")
        del x, w, x3, w3, g, wt
    out = []
    for part, what in (("fwd", "forward"), ("one", "S=1 over B*S"),
                       ("dx", "dx")):
        tot = sums[part]
        by = bound(tot["bytes"], tot["ops"], BF16_OPS)[1]
        log(f"[K-G cl] {card()}: one MC-{S} bs{BATCH} {what}, "
            f"{N_POINTWISE} sites: kernel {tot['ms']:.2f} ms, torch.einsum "
            f"{tot['library_ms']:.2f} ms, plain {tot['plain_ms']:.2f} ms, "
            f"bound {tot['bound_ms']:.2f} ms ({by})")
        out.append(dict(max_abs_err=tot["err"], ms=tot["ms"],
                        plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                        bound_by=by, library_ms=tot["library_ms"]))
    return out


def nhwc_pair(module, seed):
    """(NCHW model, NHWC model) of ``module``'s ``resnet50`` on the card:
    one seed, so the same weights and the same generator state, bf16
    compute, BN statistics from one batch (each in its layout)."""
    import torch

    pair = []
    for df in ("NCHW", "NHWC"):
        model = module.resnet50(num_classes=1000, device="cuda",
                                generator=torch.Generator().manual_seed(seed),
                                data_format=df)
        for mod in model.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.bfloat16
        pair.append(model)
    first, last = pair
    set_bn_statistics(first, images(SEED + 200))
    last.load_state_dict(first.state_dict())
    last.eval()
    return first, last


def channels_last_input(x):
    return x.permute(0, 2, 3, 1).contiguous()


def transposes(fn):
    """The cuDNN NCHW<->NHWC transpose kernels that one call of ``fn``
    launches, counted under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and any(t in e.key for t in TRANSPOSE_KERNELS))


def nhwc_paths(first, last, x):
    """(44b) The flagship ResNet-50 MC-10 bs128 224² bf16 in both layouts
    on the same weights and draws: the loop, vmap, vmap with
    ``CONV_1X1_DOT`` and ``structured=True``. NHWC against NCHW within
    2^-6 x max|logit| (other conv algorithms round bf16 at other places);
    structured equal to vmap bit for bit; ms per batch of each layout
    (host clock, median of 3 after a warm-up) and the transpose kernels of
    one profiled batch of each. Returns {path: {...}} and the counts of
    the NHWC vmap batches with ``CONV_1X1_DOT``."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    xl = channels_last_input(x)
    paths = (("loop", {}, False), ("vmap", dict(emission="vmap"), False),
             ("vmap, CONV_1X1_DOT", dict(emission="vmap"), True),
             ("structured=True", dict(structured=True), False))
    res, dot_counts, outs = {}, None, {}
    for what, kw, dot in paths:
        row = {}
        # the same draws in both layouts: the NHWC model's generator takes
        # the NCHW model's state, and each run rewinds its own
        last.conv1.generator.set_state(first.conv1.generator.get_state())
        for df, model, inp in (("NCHW", first, x), ("NHWC", last, xl)):
            def run():
                with pointwise_dot() if dot else contextlib.nullcontext():
                    return mc_forward(model, inp, NUM_MC, return_kl=False,
                                      **kw)

            reset_counts()
            out = same_seeds(model, run)
            check(tuple(out.shape) == (NUM_MC, BATCH, 1000)
                  and bool(torch.isfinite(out).all()),
                  f"[nhwc] {what} {df}: output")
            outs[(what, df)] = out.float()
            if df == "NHWC" and dot:
                dot_counts = counts()
                check(dot_counts["K-G cl"] == N_POINTWISE
                      and dot_counts["K-G"] == 0,
                      f"NHWC vmap with CONV_1X1_DOT: launches "
                      f"{nonzero(dot_counts)}, want {N_POINTWISE} K-G cl")
            row[df] = wall_ms(run, reps=3)
            row[df + "_transposes"] = transposes(run)
        a, b = outs[(what, "NHWC")], outs[(what, "NCHW")]
        diff, scale = (a - b).abs().max().item(), b.abs().max().item()
        check(diff <= scale * 2**-6, f"[nhwc] {what}: NHWC {diff:.3e} from "
              f"NCHW, limit 2^-6 x max|logit| = {scale * 2**-6:.3e}")
        row["max_abs_err"] = diff
        res[what] = row
        log(f"[nhwc] {what}, MC-{NUM_MC} bs{BATCH} {IMAGE}^2 bf16: NHWC "
            f"{row['NHWC']:.1f} ms/batch, NCHW {row['NCHW']:.1f}; cuDNN "
            f"transposes in one batch NHWC {row['NHWC_transposes']}, NCHW "
            f"{row['NCHW_transposes']}; NHWC against NCHW max|diff| "
            f"{diff:.3e} (limit 2^-6 x max|logit| = {scale * 2**-6:.3e})")
    same = [same_seeds(last, lambda: mc_forward(
        last, xl, NUM_MC, return_kl=False, **kw))
        for kw in (dict(emission="vmap"), dict(structured=True))]
    check(torch.equal(*same), "NHWC structured=True is not the vmap "
          "emission on the same draws")
    return res, dot_counts


def nhwc_train(first, last):
    """(44c) MC-4 bs128 ELBO steps through the loop and vmap (and vmap with
    ``CONV_1X1_DOT``: K-G cl forward and dx, 33 each a step) in both
    layouts from one state: one warm-up and two timed steps each, finite
    gradients, the first step's loss of each layout side by side."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step

    state = {k: v.clone() for k, v in first.state_dict().items()}
    x, y = images(SEED + 950), labels(SEED + 950)
    res, dot_counts = {}, None
    for what, emission, dot in (("loop", "scan", False),
                                ("vmap", "vmap", False),
                                ("vmap, CONV_1X1_DOT", "vmap", True)):
        row = {}
        # both layouts' first steps from one state and generator state
        g0 = first.conv1.generator.get_state()
        for df, model, inp in (("NCHW", first, x),
                               ("NHWC", last, channels_last_input(x))):
            model.load_state_dict(state)
            model.train()
            model.conv1.generator.set_state(g0)
            opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
            step = make_train_step(TRAIN_MC, BATCH, emission=emission)
            ctx = pointwise_dot() if dot else contextlib.nullcontext()
            with ctx:
                loss = float(step(model, opt, inp, y)[0])
                check(math.isfinite(loss), f"[nhwc train] {what} {df}: "
                      f"loss {loss}")
                check_grads(model, f"[nhwc train] {what} {df}")
                reset_counts()
                times = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(model, opt, inp, y)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                if df == "NHWC" and dot:
                    dot_counts = counts()
                    check(dot_counts["K-G cl"] == 2 * 2 * N_POINTWISE,
                          f"NHWC vmap steps with CONV_1X1_DOT: launches "
                          f"{nonzero(dot_counts)}, want "
                          f"{4 * N_POINTWISE} K-G cl")
            row[df] = statistics.median(times)
            row[df + "_loss"] = loss
        res[what] = row
        log(f"[nhwc train] {what}, MC-{TRAIN_MC} bs{BATCH} ELBO step: NHWC "
            f"{row['NHWC']:.1f} ms, NCHW {row['NCHW']:.1f} ms; first loss "
            f"NHWC {row['NHWC_loss']:.4f}, NCHW {row['NCHW_loss']:.4f}")
    for model in (first, last):
        model.load_state_dict(state)
        model.eval()
    return res, dot_counts


def nhwc_flipout(x):
    """(44d) Flipout ResNet-50 MC-10 bs128 through vmap in both layouts
    (one warm-up, one timed batch each), and one NHWC batch with
    ``CONV_1X1_DOT``: the mean convs through the S = 1 wrapper over the
    B*S rows, the perturbation convs through K-G cl, 33 each; its signs
    through K-H1 and K-H2 with the lanes before the channels, one each a
    layer."""
    import torch

    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_flipout_large,
    )
    from bayesian_torch_tpu_torch.parallel import mc_forward

    first, last = nhwc_pair(resnet_flipout_large, SEED + 960)
    row = {}
    for df, model, inp in (("NCHW", first, x),
                           ("NHWC", last, channels_last_input(x))):
        def run():
            return mc_forward(model, inp, NUM_MC, reduce="mean",
                              return_kl=False, emission="vmap")

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        row[df] = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(out).all()), f"Flipout vmap {df}")
    reset_counts()
    with pointwise_dot():
        out = mc_forward(last, channels_last_input(x), NUM_MC, reduce="mean",
                         return_kl=False, emission="vmap")
    torch.cuda.synchronize()
    dot_counts = counts()
    check_signs("nhwc flipout vmap CONV_1X1_DOT",
                expected_sign_launches(last, NUM_MC, vmap=True))
    check(bool(torch.isfinite(out).all())
          and dot_counts["K-G cl"] == N_POINTWISE
          and dot_counts["K-G cl S=1"] == N_POINTWISE,
          f"NHWC Flipout vmap with CONV_1X1_DOT: {nonzero(dot_counts)}")
    log(f"[nhwc flipout] vmap MC-{NUM_MC} bs{BATCH}: NHWC {row['NHWC']:.1f} "
        f"ms, NCHW {row['NCHW']:.1f} ms; with CONV_1X1_DOT (NHWC) "
        f"{nonzero(dot_counts)}")
    del first, last
    torch.cuda.empty_cache()
    return row, dot_counts


def nhwc_int8(x):
    """(44e) ``qresnet50`` calibrated (NCHW), converted with conv+BN
    folding and uint8 activations, and its NHWC twin holding the same int8
    state and quant_dicts: MC-10 bs128 on the same generator state in both
    layouts, the uint8
    activations into the pool and the logits bit for bit (the same integer
    and f32 operations on the same (B, *sp, C) memory), 540 K-F launches a
    batch each; ms per batch of each."""
    import torch

    from bayesian_torch_tpu_torch.models.bayesian import (
        quantized_resnet_variational_large as qrvl,
    )
    from bayesian_torch_tpu_torch.parallel import mc_forward

    def calibrate(model):
        prepared = [m for m in model.modules()
                    if getattr(m, "quant_prepare", False)]
        for m in prepared:
            m.quant_prepare = False
        set_bn_statistics(model, images(SEED + 500))
        for m in prepared:
            m.quant_prepare = True
        with torch.no_grad():
            for i in range(3):
                model(images(SEED + 510 + i)[:CALIB_BATCH])

    models = {df: qrvl.qresnet50(
        generator=torch.Generator().manual_seed(SEED), device="cuda",
        calibrate=calibrate if df == "NCHW" else None, fuse_conv_bn=True,
        quantize_activations=True, data_format=df)
        for df in ("NCHW", "NHWC")}
    first, last = models["NCHW"], models["NHWC"]
    # the NCHW model's int8 state and calibration into its NHWC twin
    last.load_state_dict(first.state_dict())
    for a, b in zip(first.modules(), last.modules()):
        if hasattr(a, "quant_dict"):
            b.quant_dict = a.quant_dict
    check(all(m.data_format == "NHWC" for m in last.modules()
              if hasattr(m, "data_format")), "qresnet50(data_format='NHWC')"
          " has a layer that is not NHWC")
    last.conv1.generator.set_state(first.conv1.generator.get_state())
    pooled = {}

    def hook(df):
        def keep(mod, inp, out):
            out = out[0] if isinstance(out, tuple) else out  # (x, kl)
            pooled[df] = out.q if hasattr(out, "q") else out
        return keep

    # the last residual block's output: the activations into the pool
    handles = [first.layer4[-1].register_forward_hook(hook("NCHW")),
               last.layer4[-1].register_forward_hook(hook("NHWC"))]
    row, outs = {}, {}
    reset_counts()
    for df, model, inp in (("NCHW", first, x),
                           ("NHWC", last, channels_last_input(x))):
        def run():
            return mc_forward(model, inp, NUM_MC, reduce="mean",
                              return_kl=False)

        before = counts()["K-F"]
        outs[df] = same_seeds(model, run)
        check(counts()["K-F"] - before == INT8_LAYERS * NUM_MC,
              f"INT8 {df}: {counts()['K-F'] - before} K-F launches")
        row[df] = wall_ms(run, reps=2)
    for h in handles:
        h.remove()
    check(torch.equal(pooled["NHWC"], pooled["NCHW"].permute(0, 2, 3, 1)),
          "INT8: the NHWC activations into the pool differ from NCHW's")
    row["logits_equal"] = bool(torch.equal(outs["NHWC"], outs["NCHW"]))
    check(row["logits_equal"], "INT8: NHWC logits differ from NCHW's")
    log(f"[nhwc int8] qresnet50 MC-{NUM_MC} bs{BATCH}: NHWC {row['NHWC']:.1f}"
        f" ms/batch, NCHW {row['NCHW']:.1f}; activations into the pool and "
        f"the MC-{NUM_MC} mean logits bit for bit")
    del first, last, models
    torch.cuda.empty_cache()
    return row


def nhwc_entry():
    """(44f) ``graft_entry.entry()`` at the flagship shape
    (``BTT_ENTRY_FLAGSHIP=1``): ResNet-50 NHWC, (128, 224, 224, 3), bf16,
    MC-10."""
    import os

    import torch

    from bayesian_torch_tpu_torch.graft_entry import entry

    saved = os.environ.get("BTT_ENTRY_FLAGSHIP")
    os.environ["BTT_ENTRY_FLAGSHIP"] = "1"
    try:
        fn, args = entry()
    finally:
        if saved is None:
            del os.environ["BTT_ENTRY_FLAGSHIP"]
        else:
            os.environ["BTT_ENTRY_FLAGSHIP"] = saved
    model, x = args
    check(model.data_format == "NHWC" and tuple(x.shape) == (128, 224, 224, 3),
          f"flagship entry: {model.data_format}, {tuple(x.shape)}")
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kl = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(tuple(logits.shape) == (128, 1000)
          and bool(torch.isfinite(logits).all()), "flagship entry() output")
    log(f"[nhwc entry] graft_entry.entry() with BTT_ENTRY_FLAGSHIP=1: NHWC "
        f"{tuple(x.shape)}, MC-10 bf16: logits {tuple(logits.shape)}, "
        f"{ms:.1f} ms")
    return ms


def phase_nhwc():
    """(44) Channels-last: K-G cl at the pointwise sites, the flagship
    ResNet-50 in both layouts through every inference path, the MC-4
    training steps, Flipout vmap, INT8 and the flagship entry. Returns
    ({"K-G cl": {path: launches}, "K-G cl S=1": ...}, the three K-G cl
    kernels-line entries, the summary)."""
    import torch

    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_variational_large,
    )

    t0 = time.perf_counter()
    seconds = {}
    kg_fwd, kg_one, kg_dx = kgcl_sites()
    seconds["kernel"] = time.perf_counter() - t0
    first, last = nhwc_pair(resnet_variational_large, SEED + 900)
    x = images(SEED + 901)
    infer, dot_infer = nhwc_paths(first, last, x)
    seconds["inference"] = time.perf_counter() - t0 - sum(seconds.values())
    train, dot_train = nhwc_train(first, last)
    seconds["training"] = time.perf_counter() - t0 - sum(seconds.values())
    del first, last
    torch.cuda.empty_cache()
    flipout, dot_flip = nhwc_flipout(x)
    seconds["flipout"] = time.perf_counter() - t0 - sum(seconds.values())
    int8 = nhwc_int8(x)
    seconds["int8"] = time.perf_counter() - t0 - sum(seconds.values())
    entry_ms = nhwc_entry()
    seconds["entry"] = time.perf_counter() - t0 - sum(seconds.values())
    summary = {"inference": infer, "training": train, "flipout vmap": flipout,
               "int8": int8, "entry flagship ms": entry_ms}
    log(f"[nhwc] {card()}: " + json.dumps(summary))
    log(f"[nhwc] seconds per part: "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    paths = {"K-G cl": {
        f"NHWC vmap MC-{NUM_MC} bs{BATCH} CONV_1X1_DOT, 1 batch":
        dot_infer["K-G cl"],
        f"NHWC vmap MC-{TRAIN_MC} bs{BATCH} CONV_1X1_DOT, 2 steps":
        dot_train["K-G cl"],
        f"NHWC Flipout vmap MC-{NUM_MC} CONV_1X1_DOT, 1 batch":
        dot_flip["K-G cl"]},
        "K-G cl S=1": {
        f"NHWC Flipout vmap MC-{NUM_MC} CONV_1X1_DOT, 1 batch":
        dot_flip["K-G cl S=1"]}}
    return paths, (kg_fwd, kg_one, kg_dx), summary


# --- phase 45: channels-last on the mesh paths ------------------------------

NHWC_MESH_SEED = SEED + 1000
# (emission, presample) of the fused-GEMM head's TP parts, and their
# launches a rank: one K-B with lanes; a K-B a draw
TP_PALLAS = (("vmap", "auto"), ("scan", "off"))
TP_PALLAS_LAUNCHES = {"vmap": {"K-B lanes": 1}, "scan": {"K-B": TP_MC}}


def nhwc_mesh_model():
    """ResNet-50 NHWC as phase 45 builds it in every process, bf16
    compute."""
    import torch

    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large \
        import resnet50

    model = resnet50(num_classes=1000,
                     generator=torch.Generator().manual_seed(NHWC_MESH_SEED),
                     device="cuda", data_format="NHWC")
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.bfloat16
    return model


def nhwc_mesh_parts(tmp, rank):
    """Phase 45's parts on one rank of two sharing the card, each against
    the one-process result the parent saved; every rank runs every part in
    the same order. Returns {part: result} with each part's seconds and
    launches."""
    import os

    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step
    from bayesian_torch_tpu_torch.graft_entry import _structured_flipout
    from bayesian_torch_tpu_torch.parallel import (make_mesh, mc_forward,
                                                   replicate, shard_batch,
                                                   shard_params_tp)

    ref = torch.load(os.path.join(tmp, "ref.pt"), weights_only=False)
    x, y, gens0 = ref["x"].cuda(), ref["y"].cuda(), ref["gens0"]
    model = nhwc_mesh_model()
    model.load_state_dict(ref["state"])
    model.eval()
    out = {}

    def part(name, fn):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = dict(res, seconds=round(time.perf_counter() - t0, 1),
                         launches=nonzero(counts()))
        log(f"[nhwc mesh] rank {rank} {name}: "
            + json.dumps(out[name], default=str)[:600])

    mc2 = make_mesh(mc=2)
    data2 = make_mesh(mc=1, data=2)
    tp2 = make_mesh(mc=1, data=1, model=2)

    def forward(mesh, want, **kw):
        set_gens(model, gens0)
        with torch.no_grad():
            got = mc_forward(model, shard_batch(x, mesh), NUM_MC, mesh=mesh,
                             return_kl=False, **kw)
        return {"err": max_err(got, want.cuda()), "bound": bf16_bound(want),
                "finite": bool(torch.isfinite(got).all()),
                "shape": tuple(got.shape)}

    part("mc=2 scan", lambda: forward(mc2, ref["scan"], emission="scan"))
    part("data=2 scan", lambda: forward(data2, ref["scan"],
                                        emission="scan"))
    with pointwise_dot():
        part("mc=2 vmap CONV_1X1_DOT", lambda: forward(
            mc2, ref["dot"], emission="vmap"))

    def vmap_step():
        model.load_state_dict(ref["state"])
        model.train()
        set_gens(model, gens0)
        opt = torch.optim.SGD(model.parameters(), lr=MULTIRANK_LR)
        with f32_compute(model):
            loss, _, _ = make_train_step(TRAIN_MC, BATCH, mc2,
                                         emission="vmap")(
                model, opt, shard_batch(x, mc2), y)
        want = ref["step"]
        return {"loss": float(loss), "loss_one_process": want["loss"],
                "param_err": max(max_err(p, want["after"][n].cuda())
                                 for n, p in model.named_parameters()),
                "update": want["update"]}

    part(f"mc=2 vmap MC-{TRAIN_MC} bs{BATCH} f32 SGD step", vmap_step)
    del model
    torch.cuda.empty_cache()

    def tensor_parallel(want, impl="xla", **kw):
        tp_model = nhwc_mesh_model()
        tp_model.load_state_dict(ref["state"])
        tp_model.fc.impl = impl
        replicate(tp_model, tp2)
        count = shard_params_tp(tp_model, tp2)
        tp_model.eval()
        set_gens(tp_model, gens0)
        with torch.no_grad():
            got = mc_forward(tp_model, x[:TP_BATCH], TP_MC, return_kl=False,
                             **kw)
        return {"sharded": count, "err": max_err(got, want.cuda()),
                "bound": bf16_bound(want),
                "finite": bool(torch.isfinite(got).all())}

    part(f"model=2 TP MC-{TP_MC} bs{TP_BATCH}", lambda: tensor_parallel(
        ref["tp"], emission="vmap"))
    torch.cuda.empty_cache()
    # the head on the fused sampled GEMM: the shard's rows of the whole
    # weight's counters, under the vmap emission (K-B with lanes) and
    # through the loop with presample="off" (the single draw, ROADMAP F13)
    for emission, presample in TP_PALLAS:
        part(f"pallas head model=2 TP {emission} MC-{TP_MC} bs{TP_BATCH}",
             lambda: tensor_parallel(ref[f"tp pallas {emission}"], "pallas",
                                     emission=emission, presample=presample))
        torch.cuda.empty_cache()

    def structured_flipout():
        # the NHWC Net of the JAX dryrun under mc=2, f32 without TF32
        with tf32_off():
            err = _structured_flipout(mc2, "cuda")
        return {"err": err, "bound": 1e-5, "finite": math.isfinite(err)}

    part("dryrun_multichip(2) NHWC structured Flipout", structured_flipout)
    return out


def phase_nhwc_mesh():
    """Phase 45: channels-last on the mesh paths (see the module
    docstring). Returns ({kernel: {path: launches}}, summary)."""
    import os
    import tempfile

    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step
    from bayesian_torch_tpu_torch.parallel import mc_forward

    t0 = time.perf_counter()
    model = nhwc_mesh_model()
    set_bn_statistics(model, channels_last_input(images(NHWC_MESH_SEED + 1)))
    x = channels_last_input(images(NHWC_MESH_SEED + 2))
    y = labels(NHWC_MESH_SEED + 2)
    gens0 = gen_states(model)
    refs = {}
    with torch.no_grad():
        for name, kw, ctx in (
                ("scan", dict(emission="scan"), contextlib.nullcontext),
                ("dot", dict(emission="vmap"), pointwise_dot)):
            set_gens(model, gens0)
            with ctx():
                refs[name] = mc_forward(model, x, NUM_MC, return_kl=False,
                                        **kw)
        set_gens(model, gens0)
        refs["tp"] = mc_forward(model, x[:TP_BATCH], TP_MC, return_kl=False,
                                emission="vmap")
        model.fc.impl = "pallas"
        for emission, presample in TP_PALLAS:
            set_gens(model, gens0)
            refs[f"tp pallas {emission}"] = mc_forward(
                model, x[:TP_BATCH], TP_MC, return_kl=False,
                emission=emission, presample=presample)
        model.fc.impl = "xla"
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.train()
    set_gens(model, gens0)
    opt = torch.optim.SGD(model.parameters(), lr=MULTIRANK_LR)
    with f32_compute(model):
        loss, _, _ = make_train_step(TRAIN_MC, BATCH, emission="vmap")(
            model, opt, x, y)
    step = {"loss": float(loss),
            "after": {n: p.detach().cpu().clone()
                      for n, p in model.named_parameters()},
            "update": max(max_err(p, before[n])
                          for n, p in model.named_parameters())}
    del model, before, opt
    torch.cuda.empty_cache()
    one_process_s = round(time.perf_counter() - t0, 1)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"state": state, "gens0": gens0, "x": x.cpu(),
                    "y": y.cpu(), "step": step,
                    **{k: v.cpu() for k, v in refs.items()}},
                   os.path.join(tmp, "ref.pt"))
        ranks = spawn_multirank(tmp, "nhwc_mesh_parts")
    paths = {"K-A": {}, "K-G cl": {}, "K-B": {}, "K-B lanes": {}}
    for rank, r in enumerate(ranks):
        for name, got in r.items():
            if not isinstance(got, dict):
                continue
            for k in paths:
                if got["launches"].get(k):
                    paths[k][f"NHWC mesh {name} (rank {rank})"] = \
                        got["launches"][k]
            if "bound" in got:
                check(got["finite"], f"[nhwc mesh] rank {rank} {name}: "
                      "output not finite")
                check(got["err"] <= got["bound"], f"[nhwc mesh] rank {rank} "
                      f"{name}: {got['err']:.3e} from one process, bound "
                      f"{got['bound']:.3e}")
        check(r["mc=2 scan"]["launches"].get("K-A") == 1,
              f"[nhwc mesh] rank {rank}: the mc=2 loop's launches "
              f"{r['mc=2 scan']['launches']}, want K-A 1 (its lanes)")
        dot = r["mc=2 vmap CONV_1X1_DOT"]["launches"]
        check(dot.get("K-G cl") == N_POINTWISE and not dot.get("K-G"),
              f"[nhwc mesh] rank {rank}: the mc=2 vmap batch with "
              f"CONV_1X1_DOT launched {dot}, want {N_POINTWISE} K-G cl")
        vstep = r[f"mc=2 vmap MC-{TRAIN_MC} bs{BATCH} f32 SGD step"]
        check(vstep["launches"].get("K-C dsigma", 0) > 0
              and vstep["param_err"] <= vstep["update"] / 256,
              f"[nhwc mesh] rank {rank}: f32 parameters "
              f"{vstep['param_err']:.3e} from the one-process step (its "
              f"update {vstep['update']:.3e}); {vstep}")
        tp = r[f"model=2 TP MC-{TP_MC} bs{TP_BATCH}"]
        check(tp["sharded"] > 0, f"[nhwc mesh] rank {rank}: TP sharded "
              f"{tp['sharded']}")
        for emission, want in TP_PALLAS_LAUNCHES.items():
            name = f"pallas head model=2 TP {emission} MC-{TP_MC} bs{TP_BATCH}"
            got = r[name]
            check(got["sharded"] == tp["sharded"]
                  and all(got["launches"].get(k, 0) == v
                          for k, v in want.items())
                  and not any(got["launches"].get(k) for k in (
                      "K-B", "K-B lanes") if k not in want),
                  f"[nhwc mesh] rank {rank}: {name} sharded "
                  f"{got['sharded']}, launches {got['launches']}, want "
                  f"{want}")
            log(f"[nhwc mesh] rank {rank}, {name}: {got['err']:.3e} from one "
                f"process (limit {got['bound']:.3e}), launches "
                f"{got['launches']}")
    summary = {name: {k: v for k, v in got.items() if k != "launches"}
               for name, got in ranks[0].items() if isinstance(got, dict)}
    summary["one-process references s"] = one_process_s
    log(f"[nhwc mesh] {card()}: rank 0 " + json.dumps(summary, default=str))
    for k, v in paths.items():
        check(v, f"{k} never ran on phase 45's paths")
    return paths, summary


def main(argv=None):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one inference batch and one "
                             "training step of each path and the K-B "
                             "kernel with torch.profiler")
    profile = parser.parse_args(argv).profile
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large \
        import resnet50
    from bayesian_torch_tpu_torch.ops.cuda.sampled_matmul import (
        sampled_matmul,
    )
    from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
        sample_scaled_normals_batch,
    )

    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    torch.manual_seed(SEED)
    model = resnet50(num_classes=1000,
                     generator=torch.Generator().manual_seed(SEED),
                     device="cuda")
    ka_res = phase_batch_sampler(model)
    kb_res = phase_sampled_gemm(model)
    kc_res = phase_noise_grad(model)
    kde_res = phase_gemm_backward(model)
    phase_autograd(model)
    lane_res = phase_lane_kernels(model)
    kg_res, kg_one_res, kg_dx_res = phase_mc_gemm()
    mm_res = phase_matmul_probe()

    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.bfloat16
    set_bn_statistics(model, images(SEED + 200))
    batches = [images(SEED + 1 + i) for i in range(3)]
    none = dict.fromkeys(kernel_counters(), 0)
    # the loop, presample "auto" (on): one K-A launch per batch
    main_ms, main_path = timed_mc("main", model, batches,
                                  dict(none, **{"K-A": 1}))
    kb_launches = phase_head(model, sample_scaled_normals_batch,
                             sampled_matmul, batches[0])
    mc_sanity("sanity", model, "auto")
    if profile:
        phase_profile(model, batches[0], sampled_matmul)
    model.fc.impl = "pallas"
    vmap_ms, vmap_main = timed_mc(
        "vmap main", model, batches,
        expected_vmap_launches(model, training=False), return_kl=False,
        emission="vmap")
    lanes_agree("vmap vs loop", model, batches[0])
    mc_sanity("vmap sanity", model, "vmap")
    pointwise = phase_pointwise_vmap(model, batches, vmap_ms)
    if profile:
        from bayesian_torch_tpu_torch.parallel import mc_forward
        for what, ctx in (("vmap", contextlib.nullcontext()),
                          ("vmap, CONV_1X1_DOT=True", pointwise_dot())):
            with ctx:
                profile_window(
                    f"one {what} inference batch (MC-{NUM_MC} bs{BATCH})",
                    lambda: mc_forward(model, batches[0], NUM_MC,
                                       reduce="mean", return_kl=False,
                                       emission="vmap"))
    model.fc.impl = "xla"
    del batches

    phase_vmap_train_sanity(model)
    train = phase_train(model)
    phase_train_presample(model)
    phase_train_sanity(model)
    if profile:
        phase_profile_train(model)
    vmap_train = phase_vmap_train(model)
    pointwise_train = phase_vmap_train(model, dot=True)
    if profile:
        phase_profile_train(model, emission="vmap")
    del model
    torch.cuda.empty_cache()
    flipout_dot, _, _, flipout_res = phase_flipout(profile)
    torch.cuda.empty_cache()
    kh_res = phase_signs()
    det, x, det_logits = phase_det(main_ms)
    surgery_train = phase_surgery(det, x, det_logits)
    del det, x, det_logits
    torch.cuda.empty_cache()
    phase_trainer()
    surgery_kf = phase_surgery_trainers()
    phase_entry()

    batches = [images(SEED + 1 + i) for i in range(3)]
    qmodel, float_means = phase_int8_build(batches[0])
    with torch.no_grad():
        shapes = int8_shapes(qmodel, batches[0])
    kf_res = phase_qmatmul(shapes)
    kf_launches = phase_int8_main(qmodel, batches, float_means)[1]
    if profile:
        from bayesian_torch_tpu_torch.parallel import mc_forward
        profile_window(f"one INT8 MC-{NUM_MC} batch (bs{BATCH})",
                       lambda: mc_forward(qmodel, batches[0], NUM_MC,
                                          reduce="mean", return_kl=False))
    phase_int8_frozen(qmodel, batches)
    phase_int8_sanity(qmodel, batches[0])
    del qmodel
    phase_int8_uncalibrated(batches)
    del batches
    torch.cuda.empty_cache()
    zoo, zoo_kf = phase_zoo()
    int8_paths, flipout_int8, int8_probes = phase_int8_remainder()
    lstm_paths, lstm_res = phase_lstm()
    modes_paths, modes_res = phase_modes()
    mesh_paths, mesh_res = phase_multirank()
    nhwc_paths, (kgcl_res, kgcl_one_res, kgcl_dx_res), nhwc_res = \
        phase_nhwc()
    nhwc_mesh_paths, nhwc_mesh_res = phase_nhwc_mesh()

    csrc = "bayesian_torch_tpu_torch/csrc/"
    pallas = "bayesian_torch_tpu/ops/pallas/"
    train_run = (f"training main path: make_train_step(num_mc={TRAIN_MC}, "
                 f"batch_size={BATCH}, emission='scan'), fc.impl='pallas', "
                 "presample='auto', 3 steps")
    vmap_train_run = (f"vmap training: make_train_step(num_mc={TRAIN_MC}, "
                      f"batch_size={BATCH}, emission='vmap'), "
                      "fc.impl='pallas', 3 steps")
    kernels = [
        dict(name="sample_scaled_normals_batch", route="cuda",
             source=csrc + "sampled_weights.cu",
             replaces=pallas + "sampled_weights.py:126",
             run="main path: mc_forward(num_mc=10, reduce='mean'), "
                 "presample='auto', 3 batches",
             launches=main_path["K-A"],
             paths=dict(zoo["K-A"], **lstm_paths["K-A"],
                        **modes_paths["K-A"], **mesh_paths["K-A"],
                        **nhwc_mesh_paths["K-A"]),
             **ka_res),
        dict(name="sampled_matmul", route="cuda",
             source=csrc + "sampled_matmul.cu",
             replaces=pallas + "sampled_matmul.py:62",
             run="head: fc.impl='pallas', mc_forward(num_mc=10, "
                 "presample='off'), 1 batch",
             launches=kb_launches, paths=nhwc_mesh_paths["K-B"],
             window_err=mesh_res["(g) head windows"]["K-B"], **kb_res),
        dict(name="sampled_weights_bwd (dsigma)", route="cuda",
             source=csrc + "sampled_weights_bwd.cu",
             replaces=pallas + "sampled_weights.py:138",
             run=vmap_train_run + "; one launch per layer and step",
             launches=vmap_train["K-C dsigma"],
             paths=dict(zoo["K-C dsigma"], **lstm_paths["K-C dsigma"],
                        **modes_paths["K-C dsigma"],
                        **mesh_paths["K-C dsigma"]),
             **kc_res["dsigma"]),
        dict(name="sampled_weights_bwd (drho)", route="cuda",
             source=csrc + "sampled_weights_bwd.cu",
             replaces=pallas + "sampled_weights.py:68",
             run=train_run, launches=train["K-C drho"],
             paths=dict(zoo["K-C drho"], **lstm_paths["K-C drho"],
                        **modes_paths["K-C drho"],
                        **mesh_paths["K-C drho"]),
             **kc_res["drho"]),
        dict(name="sampled_matmul_dx", route="cuda",
             source=csrc + "sampled_matmul_bwd.cu",
             replaces=pallas + "sampled_matmul.py:84",
             run=train_run, launches=train["K-D"],
             window_err=mesh_res["(g) head windows"]["K-D"], **kde_res["dx"]),
        dict(name="sampled_matmul_dw", route="cuda",
             source=csrc + "sampled_matmul_bwd.cu",
             replaces=pallas + "sampled_matmul.py:110",
             run=train_run, launches=train["K-E"],
             window_err=mesh_res["(g) head windows"]["K-E"], **kde_res["dw"]),
        dict(name="qmatmul_requant", route="cuda",
             source=csrc + "qmatmul.cu",
             replaces=pallas + "qmatmul.py:61",
             run=f"INT8 main paths: qresnet50 calibrated, fuse_conv_bn=True, "
                 f"mc_forward(num_mc={NUM_MC}, reduce='mean'), 3 batches, "
                 f"reparameterization ({INT8_LAYERS * NUM_MC} launches a "
                 f"batch) and Flipout ({INT8_LAYERS * NUM_MC}: the means; "
                 f"the perturbations are qmatmul_requant_flipout's); ms, "
                 f"plain_ms, bound_ms and library_ms are device-time sums "
                 f"over one reparameterization forward's {INT8_LAYERS} "
                 f"GEMMs; "
                 f"cifar_resnet20_bs128: the same sums over the INT8 CIFAR "
                 f"ResNet-20's GEMMs; int8_flipout: the Flipout MC-10 "
                 f"batch (host ms, profiled busy ms, idle share, K-F's "
                 f"device ms and share with its Flipout epilogue's apart, "
                 f"K-H3's); grouped_probe, "
                 f"transposed_probes: device ms of the route, of K-F's rows "
                 f"and of the plain route, per call",
             launches=kf_launches + flipout_int8["launches"],
             paths=dict(zoo["K-F"], **{
                 f"int8 reparameterization MC-{NUM_MC} bs{BATCH} batches":
                 kf_launches}, **int8_paths["K-F"], **modes_paths["K-F"],
                 **mesh_paths["K-F"]),
             cifar_resnet20_bs128=zoo_kf, int8_flipout=flipout_int8,
             grouped_probe=int8_probes["resnext"],
             transposed_probes={k: v for k, v in int8_probes.items()
                                if k.startswith("convtranspose")},
             **kf_res),
        dict(name="qmatmul_requant_flipout (K-F Flipout epilogue)",
             route="cuda", source=csrc + "qmatmul.cu",
             replaces=pallas + "qmatmul.py:61",
             run=f"INT8 Flipout main path: qresnet50 (Flipout) calibrated, "
                 f"mc_forward(num_mc={NUM_MC}, reduce='mean'), 3 batches "
                 f"(phase 38; {INT8_LAYERS * NUM_MC} a batch): K-F's second "
                 f"instantiation, each layer's perturbation GEMM with its "
                 f"output signs' product and the add to the mean in the "
                 f"epilogue (that part port-only: XLA fuses it in the JAX "
                 f"package); ms, plain_ms and bound_ms over one forward's "
                 f"{INT8_LAYERS} perturbation GEMMs (phase 46), unfused_ms "
                 f"the route before it over the same GEMMs (K-F, K-H3's "
                 f"product, torch's qadd: all device rows); grouped_probe: "
                 f"phase 40's grouped conv with the epilogue; sass: the "
                 f"instruction mix of K-F's 128-wide instantiations and "
                 f"K-H3's forms",
             launches=flipout_int8["kf_flipout_launches"],
             paths=dict(int8_paths["K-F flipout"],
                        **modes_paths["K-F flipout"]),
             grouped_probe=int8_probes["resnext flipout"], sass=SASS_MIX,
             **kh_res["K-F flipout"]),
        dict(name="sampled_matmul_batched", route="cuda",
             source=csrc + "sampled_matmul.cu",
             replaces=pallas + "sampled_matmul.py:383",
             run=f"vmap inference: mc_forward(num_mc={NUM_MC}, reduce='mean',"
                 f" emission='vmap'), fc.impl='pallas', 3 batches",
             launches=vmap_main["K-B lanes"],
             paths=dict(mesh_paths["K-B lanes"],
                        **nhwc_mesh_paths["K-B lanes"]),
             **lane_res["fwd"]),
        dict(name="sampled_matmul_dx_batched", route="cuda",
             source=csrc + "sampled_matmul_bwd.cu",
             replaces=pallas + "sampled_matmul.py:405",
             run=vmap_train_run, launches=vmap_train["K-D lanes"],
             paths=mesh_paths["K-D lanes"], **lane_res["dx"]),
        dict(name="sampled_matmul_dw_batched", route="cuda",
             source=csrc + "sampled_matmul_bwd.cu",
             replaces=pallas + "sampled_matmul.py:428",
             run=vmap_train_run, launches=vmap_train["K-E lanes"],
             paths=mesh_paths["K-E lanes"], **lane_res["dw"]),
        dict(name="mc_gemm", route="cuda", source=csrc + "mc_gemm.cu",
             replaces="benchmarks/bench_1x1_mc.py:52",
             run=f"pointwise vmap inference: ops.conv.CONV_1X1_DOT=True, "
                 f"mc_forward(num_mc={NUM_MC}, reduce='mean', emission="
                 f"'vmap'), 3 batches; ms, plain_ms, bound_ms and library_ms "
                 f"(torch.matmul, broadcast weight) are device-time sums "
                 f"over one "
                 f"forward's {N_POINTWISE} pointwise sites, bf16",
             launches=pointwise["K-G"], paths=mesh_paths["K-G"], **kg_res),
        dict(name="mc_gemm (S=1: bf16, int8)", route="cuda",
             source=csrc + "mc_gemm.cu",
             replaces="benchmarks/bench_mosaic_matmul.py:34",
             run=f"Flipout vmap inference with ops.conv.CONV_1X1_DOT=True: "
                 f"mc_forward(num_mc={NUM_MC}, presample='on', emission="
                 f"'vmap'), 1 batch (the mean convs, one weight over the "
                 f"B*S batch); ms, plain_ms, bound_ms and library_ms "
                 f"(torch.matmul, broadcast weight) are device-time sums "
                 f"over one "
                 f"forward's {N_POINTWISE} pointwise sites at batch "
                 f"{BATCH * NUM_MC}, bf16; the probe_* keys are the measured "
                 f"sums (library: torch.matmul, torch._int_mm) over the "
                 f"matmul probe's 4096^3 and 8192x4096x4096 in bf16 and int8",
             launches=flipout_dot["K-G S=1"], **kg_one_res, **mm_res),
        dict(name="mc_gemm (backward: dx = w^T g)", route="cuda",
             source=csrc + "mc_gemm.cu",
             replaces="benchmarks/bench_1x1_mc.py:52",
             run=f"pointwise vmap training: ops.conv.CONV_1X1_DOT=True, "
                 f"make_train_step(num_mc={TRAIN_MC}, batch_size={BATCH}, "
                 f"emission='vmap'), 3 steps; launches count K-G's forward "
                 f"and its dx ({N_POINTWISE} each per step); ms, plain_ms, "
                 f"bound_ms and library_ms (torch.matmul) are device-time "
                 f"sums over one "
                 f"MC-{NUM_MC} bs{BATCH} backward's {N_POINTWISE} input "
                 f"gradients, bf16",
             launches=pointwise_train["K-G"], **kg_dx_res),
        dict(name="mc_gemm_cl", route="cuda", source=csrc + "mc_gemm.cu",
             replaces="benchmarks/bench_1x1_mc.py:52",
             run=f"NHWC pointwise vmap inference: ResNet-50 "
                 f"data_format='NHWC', ops.conv.CONV_1X1_DOT=True, "
                 f"mc_forward(num_mc={NUM_MC}, emission='vmap'), 1 batch; "
                 f"ms, plain_ms, bound_ms and library_ms (torch.einsum "
                 f"'msc,soc->mso') are device-time sums over one forward's "
                 f"{N_POINTWISE} pointwise sites, x (M, S, C), bf16",
             launches=nhwc_paths["K-G cl"][
                 f"NHWC vmap MC-{NUM_MC} bs{BATCH} CONV_1X1_DOT, 1 batch"],
             paths=dict(nhwc_paths["K-G cl"], **nhwc_mesh_paths["K-G cl"]),
             **kgcl_res),
        dict(name="mc_gemm_cl (S=1)", route="cuda",
             source=csrc + "mc_gemm.cu",
             replaces="benchmarks/bench_mosaic_matmul.py:34",
             run=f"NHWC Flipout vmap inference with ops.conv.CONV_1X1_DOT="
                 f"True: mc_forward(num_mc={NUM_MC}, emission='vmap'), 1 "
                 f"batch (the mean convs, one weight over the M*S rows); ms, "
                 f"plain_ms, bound_ms and library_ms (torch.einsum "
                 f"'mc,oc->mo') are device-time sums over the "
                 f"{N_POINTWISE} sites at {BATCH * NUM_MC} images, bf16",
             launches=nhwc_paths["K-G cl S=1"][
                 f"NHWC Flipout vmap MC-{NUM_MC} CONV_1X1_DOT, 1 batch"],
             paths=nhwc_paths["K-G cl S=1"], **kgcl_one_res),
        dict(name="mc_gemm_cl (backward: dx = g w)", route="cuda",
             source=csrc + "mc_gemm.cu",
             replaces="benchmarks/bench_1x1_mc.py:52",
             run=f"NHWC pointwise vmap training: ops.conv.CONV_1X1_DOT="
                 f"True, make_train_step(num_mc={TRAIN_MC}, batch_size="
                 f"{BATCH}, emission='vmap'), 2 steps; launches count the "
                 f"forward and dx ({N_POINTWISE} each a step); ms, plain_ms, "
                 f"bound_ms and library_ms (torch.einsum) are device-time "
                 f"sums over one MC-{NUM_MC} bs{BATCH} backward's "
                 f"{N_POINTWISE} input gradients, bf16",
             launches=nhwc_paths["K-G cl"][
                 f"NHWC vmap MC-{TRAIN_MC} bs{BATCH} CONV_1X1_DOT, 2 steps"],
             **kgcl_dx_res),
    ]
    flipout_run = (f"Flipout main path: resnet_flipout_large.resnet50, "
                   f"mc_forward(num_mc={NUM_MC}, reduce='mean'), the loop, "
                   f"3 batches (phase 26); ms, plain_ms and bound_ms over "
                   f"one batch's sign work through the loop (phase 46: "
                   f"{INT8_LAYERS * NUM_MC} launches, bf16)")
    vmap_run = f"Flipout vmap MC-{NUM_MC} bs{BATCH}, 3 batches"
    kernels += [
        dict(name="sign_flip (K-H1)", route="cuda",
             source=csrc + "flipout_signs.cu",
             replaces="bayesian_torch_tpu/ops/sampling.py:104",
             run=flipout_run + "; x * signs of each layer's input",
             launches=flipout_res["loop_signs"]["K-H1"],
             paths={vmap_run: flipout_res["vmap_signs"]["K-H1"]},
             **kh_res["K-H1"]),
        dict(name="sign_combine (K-H2)", route="cuda",
             source=csrc + "flipout_signs.cu",
             replaces="bayesian_torch_tpu/ops/sampling.py:104",
             run=flipout_run + "; mean + pert * signs of each layer's "
                 "output",
             launches=flipout_res["loop_signs"]["K-H2"],
             paths={vmap_run: flipout_res["vmap_signs"]["K-H2"]},
             **kh_res["K-H2"]),
        dict(name="qsign_mul (K-H3)", route="cuda",
             source=csrc + "flipout_signs.cu",
             replaces="bayesian_torch_tpu/ops/sampling.py:104",
             run=f"INT8 Flipout main path: qresnet50 (Flipout) calibrated, "
                 f"mc_forward(num_mc={NUM_MC}, reduce='mean'), 3 batches "
                 f"(phase 38: the input pass, one a layer and draw); ms, "
                 f"plain_ms and bound_ms over one batch's "
                 f"{INT8_LAYERS * NUM_MC} input passes with the requantize "
                 f"(phase 46), products_*: the same over its "
                 f"{2 * INT8_LAYERS * NUM_MC} products without it",
             launches=flipout_int8["kh3_launches"], **kh_res["K-H3"]),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never ran in {k['run']}")
    log(f"[surgery] launches in the converted ResNet-50's three MC-4 "
        f"bs{BATCH} steps: { {k: v for k, v in surgery_train.items() if v} }"
        f"; K-F launches in the bnn2qbnn pipeline: {surgery_kf}")
    log(f"[lstm] {card()}: " + json.dumps(lstm_res))
    log(f"[modes] {card()}: " + json.dumps(modes_res, default=str))
    log(f"[multirank] {card()}: (a) {mesh_res['(a) one-rank NCCL world']},"
        f" (e) loader batches/s {mesh_res['(e) loader batches/s']}")
    log(f"[nhwc] {card()}: " + json.dumps(nhwc_res))
    log(f"[nhwc mesh] {card()}: " + json.dumps(nhwc_mesh_res, default=str))
    log(f"[time] profiler sessions of the kernel timings: "
        f"{SESSIONS['sessions']}, taken again {SESSIONS['retried']}")
    log(f"[time] every phase passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
