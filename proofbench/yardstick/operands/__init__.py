"""Operand kinds, one module each, found by name: `<kind>.py` has
`draw(g, spec)`, one value drawn from the generator `g` (`spec` is the
traffic mix's `scalar` entry, which only the scalar reads).  A
configuration's `operands` names them, so a new kind is a new file."""
