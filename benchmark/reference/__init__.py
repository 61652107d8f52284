"""The benchmark's plain reference: what ``correct`` is decided against.

Plain PyTorch and NumPy, written from each model family's published
description (Wave-U-Net: Stoller et al. 2018) and from the port's
documented semantics, and importing nothing of the program under test
(``waveunet_tpu_torch``) nor of the JAX package. A family's forward
lives here, and ``families/<network>.py`` points at it. Every function
takes the benchmark's own inputs (its seeded weights, songs and bank
rows) and computes again whatever the program derives from them.

  * ``sources``: the sources of a configuration's task;
  * ``engine``: song separation over any network's windowed forward:
    resampling, zero padding, context padding, windows at hop = output
    length with the last right-aligned, stitching in window order (later
    writes win), the difference source;
  * ``shapes``: Wave-U-Net's valid-convolution shape algebra (window input
    and output lengths, the automatic inference window);
  * ``waveunet``: the Wave-U-Net forward at inference and in training,
    both upsamplings, both output types;
  * ``resample``: the Kaiser-windowed sinc polyphase resampler;
  * ``train``: the bank quantisation, the sampler's counter-based draws,
    the loss and Adam.

Precision: ``"fp32"`` is float32 with TF32 off; ``"tf32"`` rounds every
convolution's operands to TF32 (10 mantissa bits) first, the benchmark's
control, the nearest precision below the one the configurations state.
"""
