"""unet_roofline.etl: the four U-Nets' FLOPs in the traced window (the same
frozen count as ``mfu.etl``) over the device time of the kernels that
compute their convs and transposed convs (the union of their spans: within
a CUDA graph cuDNN's kernels may run side by side), as a share of one
card's float32 peak (67 TFLOP/s: float32 FFMA, TF32 off).

The kernels matched are cuDNN's for the convs, as an H100 with cuDNN 9
(torch 2.11, CUDA 12.8) names them: implicit-GEMM convs
(``sm80_xmma_fprop_implicit_gemm_...``), the transposed convs' data-gradient
engine (``cudnn::detail::dgrad_engine``), FFT-tiled convs
(``fft2d_r2c_32x32``, ``fft2d_c2r_32x32`` and their complex GEMM
``sm80_xmma_gemm_cf32cf32_...``), the head's ``conv2d_grouped_direct_kernel``,
and the layout and padding passes cuDNN runs for them
(``tensorTransformGeneric``, ``nchwAddPaddingKernel``,
``scalePackedTensor_kernel``); a name holding ``convolve`` is taken too.
Nothing else in the cell launches such a kernel: the STFTs are cuFFT's
``vector_fft_symm_*``, the resampler a real cuBLAS GEMM
(``gemm_f32f32``), the BatchNorms ``bn_fw_inf``, the log-VQT the port's
``cascade_kernel`` and ``octaves_kernel``. Nothing where the window holds
no such kernel."""

from benchmark.harness import union_s
from benchmark.reference.counts import PEAK_FP32_FLOPS

MATCH = ("fprop", "dgrad", "convolve", "conv2d_grouped_direct", "fft2d_r2c", "fft2d_c2r", "gemm_cf32",
         "tensorTransformGeneric", "nchwAddPaddingKernel", "scalePackedTensor")


def unet_kernel(name: str) -> bool:
    return any(m in name for m in MATCH)


def read(ctx):
    flops = ctx["facts"].get("flops")
    if not flops or ctx["trace"] is None:
        return None
    seconds = union_s((a, b) for n, a, b in ctx["trace"].device if unet_kernel(n))
    return 100.0 * flops / seconds / PEAK_FP32_FLOPS if seconds else None
