"""Fixture: a group lookup naming a mesh axis that doesn't exist."""


def heads_group(mesh):
    return mesh.get_group("tpu")  # "tpu" is a typo for "tp"
