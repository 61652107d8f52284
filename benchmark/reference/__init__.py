"""The benchmark's plain reference: what ``correct`` is decided against.

Plain PyTorch and NumPy, written from the published description of
Wave-U-Net (Stoller et al. 2018) and of the port's documented semantics,
and importing nothing of the program under test (``waveunet_tpu_torch``)
nor of the JAX package. Every function takes the benchmark's own inputs
(its seeded weights, songs and bank rows) and computes again whatever the
program derives from them.

  * ``shapes``: the valid-convolution shape algebra (window input and
    output lengths, the automatic inference window);
  * ``waveunet``: the forward at inference and in training, both
    upsamplings, both output types;
  * ``engine``: song separation: resampling, zero padding, context padding,
    windows at hop = output length with the last right-aligned, stitching
    in window order (later writes win), the difference source;
  * ``resample``: the Kaiser-windowed sinc polyphase resampler;
  * ``train``: the bank quantisation, the sampler's counter-based draws,
    the loss and Adam.

Precision: ``"fp32"`` is float32 with TF32 off; ``"tf32"`` rounds every
convolution's operands to TF32 (10 mantissa bits) first, the benchmark's
control, the nearest precision below the one the configurations state.
"""
