"""aaltoasr_tpu_torch: aaltoasr_tpu on PyTorch and CUDA.

A port of the JAX package (`aaltoasr_tpu/`, which stays the reference)
to PyTorch on an NVIDIA Hopper GPU.  It mirrors the reference's layout
and names, so a module's counterpart is found by its path:

formats   host-side readers/writers, copied from the reference (the
          reference package imports jax eagerly, so none of it is
          imported here)
frontend  the feature DAG (framing, FFT, mel, DCT, power, deltas, ...)
ops       log-semiring helpers, GMM scoring, and the two hand-written
          CUDA kernels (`ops/frontend_cuda.py`, `ops/gmm_cuda.py`;
          sources under `csrc/`)
models    PhoneProbs: audio -> features -> LNA log-probs
decoder   lexical prefix tree, backoff-FSA LM walk, the exact
          token-passing engine and the dense beam search, `Toolbox`
cli       `phone_probs`, `recognize`, `decode`, `feacat`, `feadot`

The entry points (the CLIs, `PhoneProbs`, `Toolbox`, `BeamSearch`,
`DenseBeamSearch`, ...) run on the GPU unless the caller asks for the
CPU (`device.py`).

`synth.py` builds the benchmark's synthetic tasks without jax, and
`convert.py` carries reference objects across for the parity tests.
Importing this package imports no submodule, and no module imports jax.
"""

__version__ = "0.1.0"
