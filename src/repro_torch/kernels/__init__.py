"""The port's kernels: counter RNG, device dispatch, build; QSGD, natural,
flash attention, the selective scan and the threefry array draws.

The public wrappers below are the reference's ``repro.kernels`` exports
(its TPU-only ``on_tpu``, ``autotune_rows`` and ``default_interpret``
have no counterpart).  Importing them builds nothing: each kernel is
built inside the first call that launches it.
"""
from repro_torch.kernels.qsgd.ops import qsgd_compress
from repro_torch.kernels.qsgd.kernel import qsgd_fused, qsgd_pack, qsgd_unpack
from repro_torch.kernels.natural.ops import natural_compress
from repro_torch.kernels.natural.kernel import natural_fused
from repro_torch.kernels.selective_scan.ops import selective_scan_op
from repro_torch.kernels.flash_attention.ops import flash_attention_op

__all__ = ["qsgd_compress", "qsgd_fused", "qsgd_pack", "qsgd_unpack",
           "natural_compress", "natural_fused", "selective_scan_op",
           "flash_attention_op"]
