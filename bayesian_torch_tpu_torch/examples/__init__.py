"""Example trainers of the port (counterparts of
``bayesian_torch_tpu/examples``): the ImageNet, MNIST and CIFAR-10
trainers, ``quantization_test`` and the LSTM time-series trainer
``main_bayesian_lstm_timeseries``, with their engine and data helpers."""
