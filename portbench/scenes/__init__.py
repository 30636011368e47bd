"""Scene recipes, frozen: each `build(mod, cfg, seed)` fills a SceneBuilder
of the builder module `mod` (the port's `tracer_torch.scene.builder` or
the reference's `portbench.reference.builder`: the same API), so both
sides get the same arrays."""
