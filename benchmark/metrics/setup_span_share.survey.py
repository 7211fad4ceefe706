"""Share of the survey fields' wall in cli.run's set-up, by the program's
own spans: the weights' load (`cli.load_weights`), the model's build with
them (`cli.build`), the preprocessing chain (`cli.preprocessor`), the FITS
header and tile grid (`sfinder.header`) and the engine's copy, BatchNorm
fold, cast and move to the device (`engine.prepare`).  The inside twin of
cli_setup_share.survey: the gap between the two is set-up no span
covers."""

from harness.phases import share

LAYER = "CLI and weights (cli/run.py, models/convert.py)"
SOURCE = "program_span"
MOVES = "survey_tiles_per_s"
UNIT = "%"
SPANS = ("cli.load_weights", "cli.build", "cli.preprocessor",
         "sfinder.header", "engine.prepare")


def read(ctx):
    return share(ctx, SPANS)
