"""The training step's model FLOPs (one forward and backward of the
backbone, counted once by ``torch.utils.flop_counter.FlopCounterMode``)
times the steps of the measured window, over the window's seconds times the
H100's dense bf16 peak (989 TFLOP/s), in %."""

BF16_DENSE_FLOPS = 989e12


def read(trace):
    flops = trace.extras.get("model_flops_per_step")
    if not flops:
        return None
    return 100.0 * flops * trace.window_batches / (trace.extras["window_s"] * BF16_DENSE_FLOPS)
