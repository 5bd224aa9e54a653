"""setup_s: seconds from the start of the process to the start of the
window: imports, the CUDA context, building the model, drawing weights and
inputs, and the warm-up (the checked steps, or the warm ticks); the first
run of a checkout also builds the kernels with nvcc."""


def read(view):
    return view.setup_s
