"""The paper's own workload: 784-300-10 MLP trained by backprop on the
crossbar (MNIST stand-in digits; see data/synthetic.py).  The port's copy
of ``repro.configs.mnist_mlp``."""
MLP_SIZES = (784, 300, 10)
LR = 0.05
BATCH = 10
EPOCHS = 4
