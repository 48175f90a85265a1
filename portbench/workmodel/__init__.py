"""The work model: operations and bytes of the port's entry points, counted
from their shapes, and the published peaks of the card."""
