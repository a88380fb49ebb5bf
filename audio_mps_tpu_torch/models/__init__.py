"""The pure-state cMPS model: parameters, cell, eager core, object API."""
