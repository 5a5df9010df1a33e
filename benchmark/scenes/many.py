"""The many-object scene as the CLI builds it (``--scene many``), its
spheres drawn from the configuration's ``seed``."""


def build(config: dict, cfg, device):
    from ttrt_torch import assets
    from ttrt_torch.mesh.scene import many_sphere_scene

    sky = assets.load_skybox(config["sky"], device=device)
    return many_sphere_scene(sky, config["n_spheres"], cfg.width, cfg.height,
                             seed=config["seed"], dtype=cfg.dtype,
                             device=device)
