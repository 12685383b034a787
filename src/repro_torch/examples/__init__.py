"""The port's counterparts of ``examples/*.py``, one module each, run as
``python -m repro_torch.examples.<name>`` (on the card unless
``--device cpu``): ``quickstart`` (federated MNIST under a degrading edge
network, default against tuned TCP), ``edge_africa`` (every link profile
of the paper's Tables I / II), ``tcp_tuning`` (the TCP sweeps, the greedy
tuner and the adaptive daemon; numpy only) and ``train_100m`` (a
~100M-parameter LM trained with local-SGD, checkpoints and a resume). Each
keeps the reference script's function names and printed lines."""
