"""Fixture rules: "heads" is never used by any spec in this tree."""

FIXTURE_RULES = {
    "batch": "dp",
    "heads": "tp",  # dead: no model spec names it
}
