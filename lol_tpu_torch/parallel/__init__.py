"""Device meshes and sharded pipelines (counterpart of `lol_tpu/parallel`)."""
