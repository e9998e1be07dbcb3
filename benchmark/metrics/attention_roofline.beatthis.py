"""attention_roofline.beatthis: the attention FLOPs of the traced window (q k^T
and p v of every attention call of every chunk tracked, at the frozen count of
``reference/beat_this.attention_flops``, 55.64 GFLOP a 1,500-frame chunk)
over the device time of the kernels that compute attention, as a share of
one card's float32 peak (67 TFLOP/s: the products are float32 FFMA GEMMs,
TF32 off).

The kernels matched: cuBLAS's GEMMs in the "nn" layout (names such as
``sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8_...`` and
``gemmSN_NN_kernel``), which the program uses for its two attention
products alone (every linear layer is x W^T, a "tn" GEMM), and the softmax
kernels (``softmax_warp_forward``, ``cunn_SoftMaxForward``), which nothing
else in the model launches. Nothing where the window holds no such kernel."""

from benchmark.reference.counts import PEAK_FP32_FLOPS


def attention_kernel(name: str) -> bool:
    gemm = "gemm" in name.lower() and ("_nn_" in name or "_NN_" in name)
    return gemm or "softmax_warp_forward" in name or "SoftMaxForward" in name


def read(ctx):
    flops = ctx["facts"].get("attn_flops")
    if not flops or ctx["trace"] is None:
        return None
    seconds = sum(b - a for n, a, b in ctx["trace"].device if attention_kernel(n)) / 1e6
    return 100.0 * flops / seconds / PEAK_FP32_FLOPS if seconds else None
