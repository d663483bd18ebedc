# Launch layer: the serving entry point (serve.py).
