"""Multi-GPU rendering: scene sharding (`scene_shard`, geometry split into
morton parts with one BVH each, rays replicated) and the process group of a
pixel-parallel or scene-sharded render (`dist`)."""
