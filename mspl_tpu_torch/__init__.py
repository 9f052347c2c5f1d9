"""PyTorch/CUDA port of mspl_tpu: multi-source pseudo-label segmentation.

The JAX package `mspl_tpu` is the reference; this package mirrors its module
names so each module's counterpart is easy to find (`pseudo/generate.py` here
ports `mspl_tpu/pseudo/generate.py`, and so on).  It imports torch and numpy
only.  Every Pallas kernel on the pseudo-label path has a hand-written CUDA
kernel for Hopper (sm_90a) in `csrc/`, built with nvcc at first use and bound
with ctypes (`ops/_cuda.py`); beside each kernel sits its plain PyTorch
version, which CPU tensors take.

Entry points run on the card unless the caller passes `device="cpu"`:
`pseudo.generate.make_source`, `PseudoLabelGenerator`,
`generate_pseudo_labels`, `engine.train.create_train_state`,
`make_train_step`, `make_eval_step` and `train_segmentation`,
`engine.train_cls.make_cls_train_step`, `make_cls_eval_step` and
`train_classification`, and `pseudo.self_training.self_training`, which
move the model there; the
command line (`python -m mspl_tpu_torch.cli`) runs on the card and fails
without one.
"""

__all__ = ["cli", "data", "engine", "layers", "models", "ops", "pseudo",
           "utils"]
