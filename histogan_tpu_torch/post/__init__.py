"""Post-processing of recolored images on the host (numpy, scipy, cv2 and
the native BGU solver), copied from ``histogan_tpu/post/``."""

from histogan_tpu_torch.post.imresize import imresize  # noqa: F401
from histogan_tpu_torch.post.mkl import color_transfer_MKL, MKL  # noqa: F401
from histogan_tpu_torch.post.pyramid import pyramid_upsampling  # noqa: F401
