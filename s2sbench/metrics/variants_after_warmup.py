"""Program variants the batched engines dispatched for the first time
after warm-up (``s2s_tpu_torch/utils/compile_guard.py``'s ``CompileWatch``)."""


def read(run):
    return float(run.variants_after_warmup)
