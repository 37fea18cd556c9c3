/* Hash router (the role vue-router plays in the reference,
 * Visualization_frontend/src/router/index.ts: three routes mounted in a
 * shared layout).  Each route maps to a view module exposing
 * mount(el) -> optional unmount cleanup.  Navigation re-renders the outlet
 * and toggles the nav's active link.
 */

export class Router {
  constructor(outlet, routes, { defaultPath = '/dashboard' } = {}) {
    this.outlet = outlet;
    this.routes = routes; // { '/dashboard': {title, view}, ... }
    this.defaultPath = defaultPath;
    this.current = null;
    this._cleanup = null;
    window.addEventListener('hashchange', () => this._render());
  }

  start() {
    if (!this.path() || !this.routes[this.path()]) {
      location.hash = '#' + this.defaultPath;
    }
    this._render();
  }

  path() {
    return location.hash.replace(/^#/, '');
  }

  go(path) {
    location.hash = '#' + path;
  }

  _render() {
    const path = this.routes[this.path()] ? this.path() : this.defaultPath;
    const route = this.routes[path];
    if (this._cleanup) {
      this._cleanup();
      this._cleanup = null;
    }
    this.outlet.replaceChildren();
    this.current = path;
    const maybeCleanup = route.view.mount(this.outlet);
    if (typeof maybeCleanup === 'function') this._cleanup = maybeCleanup;
    document.title = `deepflows_tpu — ${route.title}`;
    for (const a of document.querySelectorAll('nav [data-route]')) {
      a.classList.toggle('active', a.dataset.route === path);
    }
  }
}
