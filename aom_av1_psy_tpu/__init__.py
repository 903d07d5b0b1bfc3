"""aom_av1_psy_tpu — an AV1 encode/decode engine in JAX/XLA.

A from-scratch rebuild of the capabilities of BlueSwordM/aom-av1-psy
(a psychovisually tuned fork of libaom v3.5.0) as batched device
programs, run on an NVIDIA GPU:

- ``normative/``  — AV1 spec constants, enums and tables (quantizer lookups,
  default CDFs, scan orders, cosine tables). Mirrors the *data* of
  ``av1/common/quant_common.c``, ``token_cdfs.h`` etc. in the reference.
- ``ops/``        — the batched compute kernel zoo (transforms, quantize,
  intra/inter prediction, SAD/variance metrics, in-loop filters) as JAX
  programs. Replaces ``aom_dsp/`` + ``av1/common/`` SIMD + RTCD.
- ``ec/``         — the daala-derived multisymbol range coder
  (``aom_dsp/entenc.c`` / ``entdec.c``) with CDF adaptation.
- ``bitstream/``  — OBU/IVF/y4m container and header syntax
  (``av1/encoder/bitstream.c``, ``av1/decoder/obu.c``, ``common/``).
- ``decoder/``    — frame decode pipeline (``av1/decoder/``).
- ``encoder/``    — encode pipeline: mode/partition/TX search, rate control,
  psy tuning (``av1/encoder/``).
- ``parallel/``   — mesh sharding of the KEY frame's tile columns;
  replaces the pthread worker pool (``ethread.c``).
- ``native/``     — C++ host-side runtime for inherently serial hot paths
  (range-coder bit I/O, container packing) with ctypes bindings.
"""

__version__ = "0.1.0"
