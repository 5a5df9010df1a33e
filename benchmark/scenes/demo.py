"""The demo scene as the CLI builds it (``--scene demo``)."""


def build(config: dict, cfg, device):
    from ttrt_torch import app

    return app.make_scene("demo", cfg, config["sky"], device=device)
