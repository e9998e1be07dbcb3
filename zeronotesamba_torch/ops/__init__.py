"""Signal-processing ops: filterbank constants, log-VQT, HPSS, resampling."""
