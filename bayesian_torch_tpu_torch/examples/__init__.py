"""Example trainers of the port (counterparts of
``bayesian_torch_tpu/examples``): the ImageNet, MNIST and CIFAR-10
trainers and ``quantization_test``, with their engine and data helpers."""
