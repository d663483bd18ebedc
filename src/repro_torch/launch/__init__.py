# Launch layer: the serving entry point (serve.py) and the sharded fleet's
# device layout (mesh.py).
