"""Set-up: from the start of the run (imports done) to the first timed
job: model files, inputs, the program's load and its warm-up."""


def read(window):
    return window["setup_s"]
