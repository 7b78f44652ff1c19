"""The reference's MATLAB scripts, on the port's MATLAB ``imresize``
(``utils/matlab_functions.py``) on the host: ``back_projection`` and
``generate_lr_vimeo90k``."""
