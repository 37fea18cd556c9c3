/* WebSocket client with bounded-backoff reconnect (the reference's
 * Visualization_frontend/src/utils/websocket.ts: connect / onMessage
 * handler registry / automatic reconnect).  Superset: exponential backoff
 * with jitter instead of a fixed 3 s retry, and an onState hook so the UI
 * can show connection health.
 */

export class WebSocketClient {
  constructor(url, { maxBackoffMs = 15000 } = {}) {
    this.url = url;
    this.maxBackoffMs = maxBackoffMs;
    this.handlers = [];
    this.stateHandlers = [];
    this.attempts = 0;
    this.closed = false;
    this.ws = null;
  }

  connect() {
    this.closed = false;
    this._open();
  }

  _open() {
    this.ws = new WebSocket(this.url);
    this.ws.onopen = () => {
      this.attempts = 0;
      this._emitState('open');
    };
    this.ws.onmessage = (event) => {
      let msg;
      try {
        msg = JSON.parse(event.data);
      } catch {
        return; // non-JSON frame: ignore
      }
      for (const fn of this.handlers) fn(msg);
    };
    this.ws.onclose = () => {
      this._emitState('closed');
      if (!this.closed) this._reconnect();
    };
    this.ws.onerror = () => this._emitState('error');
  }

  _reconnect() {
    this.attempts += 1;
    const base = Math.min(this.maxBackoffMs, 500 * 2 ** this.attempts);
    const delay = base / 2 + Math.random() * (base / 2); // jitter
    this._emitState('reconnecting');
    setTimeout(() => {
      if (!this.closed) this._open();
    }, delay);
  }

  onMessage(fn) {
    this.handlers.push(fn);
    return () => {
      this.handlers = this.handlers.filter((h) => h !== fn);
    };
  }

  onState(fn) {
    this.stateHandlers.push(fn);
  }

  _emitState(state) {
    for (const fn of this.stateHandlers) fn(state);
  }

  close() {
    this.closed = true;
    if (this.ws) this.ws.close();
  }
}

export function wsUrl(path = '/ws') {
  const protocol = location.protocol === 'https:' ? 'wss:' : 'ws:';
  return `${protocol}//${location.host}${path}`;
}
