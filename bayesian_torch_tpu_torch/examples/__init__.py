"""Example trainers of the port (counterparts of
``bayesian_torch_tpu/examples``): so far the Bayesian ImageNet trainer,
``main_bayesian_imagenet.py``, with its engine and data helpers."""
