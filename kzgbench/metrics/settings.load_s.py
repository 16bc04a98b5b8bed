"""settings.load_s: the harness's span around api.load_trusted_setup_file()
and the first touch of the cell's own tables (traffic "tables"), which
later runs in a checkout read from its cache."""


def read(run):
    return run.settings_load_s
