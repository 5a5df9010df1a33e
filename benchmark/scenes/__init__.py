"""The program's scene of each scene kind, found by the kind's name:
``scenes/<kind>.py`` defines ``build(config, cfg, device)``, the scene
``run_animation`` is given."""
