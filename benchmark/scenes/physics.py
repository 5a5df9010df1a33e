"""The physics tier as the CLI runs it (``--scene physics``):
``run_physics`` builds its own demo scene and drops its spheres from t = 0
on every call, so ``build`` builds nothing and returns None, and
``drive`` calls ``run_physics`` in ``window.drive``'s place."""


def build(config: dict, cfg, device):
    return None


def drive(app, cfg, config: dict, loop: dict, scene, seed: int, device,
          sink, clock, max_frames=None) -> None:
    """One call of ``run_physics`` as the CLI makes it, non-interactive,
    with no checkpoint, into ``sink``, timed by ``clock``; ``scene`` and
    ``seed`` are unused (the world is the configuration's)."""
    if loop["batch"] > 1 or loop["pipeline"] or loop["pathtrace"]:
        raise ValueError("run_physics runs one frame at a time, ray traced")
    app.run_physics(cfg, config["sky"], max_frames=max_frames,
                    interactive=False, encode=loop["encode"], device=device,
                    stream=sink, timers=clock, renderer=config["renderer"])
