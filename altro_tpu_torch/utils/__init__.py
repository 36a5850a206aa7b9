from . import logging
