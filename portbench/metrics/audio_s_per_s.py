"""Audio seconds per wall second: every completed call's valid audio over the window's length (host clock)."""


def read(ctx):
    return ctx.window.audio_s / ctx.window.window_s
