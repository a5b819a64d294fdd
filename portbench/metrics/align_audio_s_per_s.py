"""Audio seconds of every job that started in the window, over the
seconds from the window's start to the end of the last of them."""


def read(window):
    return window["audio_s"] / window["seconds"]
