"""The README's examples on grafx_tpu_torch (PyTorch, on the card by
default): each module is a script with ``main(argv=None)``, which parses
its arguments, prints what it measured and returns it as a dict."""
