"""The path-traced many-object scene as the CLI builds it (``--pathtrace
--scene many``): the ``MeshScene`` of ``scenes/many.py``; the loop's
``pathtrace`` flag makes it path-traced."""

from benchmark.scenes import many


def build(config: dict, cfg, device):
    return many.build(config, cfg, device)
