"""bake_s: seconds of the program's scene bake and upload
(`scene.build.build_scene`, host clock around the call)."""


def read(ctx):
    return ctx["bake_s"]
