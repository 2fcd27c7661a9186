"""Trainers ported from the JAX package's examples, run as
``python -m horovod_tpu_torch.examples.<name>``:

- ``cnn_benchmark``: ResNet-50/101, Inception V3, VGG-16 or ResNetTiny on
  synthetic images, images/s per card (``examples/jax_cnn_benchmark.py``);
- ``bert_pretraining``: BERT MLM pretraining with fp16 gradient
  compression, sequences/s per card, optionally sequence-parallel
  (``examples/jax_bert_pretraining.py``);
- ``gpt_long_context``: GPT trained sequence-parallel over a
  ``("dp", "sp")`` mesh with ring attention, tokens/s
  (``examples/jax_gpt_long_context.py``);
- ``mnist_mlp``: the MLP on synthetic MNIST-shaped data
  (``examples/jax_mnist_mlp.py``);
- ``elastic_mnist``: the elastic trainer, run under the port's launcher
  (``examples/torch_elastic_mnist.py``, ``examples/jax_elastic_mnist.py``);
  its ``main(argv)`` calls ``hvd.init(device=--device)`` itself;
- ``spark_estimator``: ``TorchEstimator.fit`` on a pandas DataFrame with
  the local backend (the torch half of ``examples/spark_estimator.py``);
  the estimator's worker calls ``hvd.init(device=--device)`` itself;
- ``microbenchmark``: MiB/s of each collective on the negotiated spine or
  compiled as functional collectives (``examples/jax_microbenchmark.py``);
  its ``main(argv)`` calls ``hvd.init(device=--device)`` itself.

Each is a ``main(argv)`` that runs on ``hvd.device()``: the card, unless
the caller ran ``hvd.init(device="cpu")`` first.  It returns what it
measured besides printing the reference's result line.
"""
