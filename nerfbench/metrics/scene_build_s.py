"""scene_build_s: seconds from the cloud on the device to a renderable grid
(and, for eval, the attribute table): the program's set-up of the scene."""


def read(rec):
    return rec.get("scene_build_s")
