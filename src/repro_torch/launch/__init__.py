"""Device meshes for sharded serving (``launch/mesh.py``)."""
