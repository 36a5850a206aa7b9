from . import problems, unicycle
