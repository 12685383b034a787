"""Model payloads. This slice ports the paper's MNIST CNN; the LM side of
``repro.models`` is not ported yet."""
