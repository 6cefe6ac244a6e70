"""Example apps on the port (counterparts of the repo's examples/):
each defines init/update/render and runs headless through
common.run_example, on the card unless --cpu asks for the CPU:

    python -m datum_tpu_torch.examples.<name> [--frames N --width W --height H
                                              --out PNG --overlay --cpu]

with <name> one of triangle, material, skybox, ocean, stardust,
asteroids, datumtest and city; teapot and character read a pack
(--pack PATH, required).
"""
