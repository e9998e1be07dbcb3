"""vqt_roofline: the two log-VQT kernels' least times (frozen byte and
operation counts against the published peaks) over their device time in the
trace, summed over both kernels and every launch."""


def read(ctx):
    bounds = ctx["facts"].get("vqt_bounds_s")
    if not bounds or ctx["trace"] is None:
        return None
    least = spent = 0.0
    for kernel, bound in bounds.items():
        seconds, launches = ctx["trace"].device_time(kernel)
        if not launches:
            return None
        least += launches * bound
        spent += seconds
    return 100.0 * least / spent
